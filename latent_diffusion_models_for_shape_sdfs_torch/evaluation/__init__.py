from latent_diffusion_models_for_shape_sdfs_torch.evaluation.chamfer import (  # noqa: F401
    chamfer_l2, chamfer_l2_directed,
)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation.fscore import (  # noqa: F401
    fscore, normal_consistency, sdf_normals,
)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation.mesh_sample import (  # noqa: F401
    sample_mesh_surface, sample_mesh_surface_with_normals,
)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation.generative import (  # noqa: F401
    emd_exact, evaluate_generated, evaluate_generated_emd_host, mmd_coverage,
    one_nna,
)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation.device_metrics import (  # noqa: F401
    evaluate_generated_device, pairwise_metric,
)
