from latent_diffusion_models_for_shape_sdfs_torch.evaluation.chamfer import (  # noqa: F401
    chamfer_l2,
)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation.fscore import (  # noqa: F401
    fscore, normal_consistency, sdf_normals,
)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation.mesh_sample import (  # noqa: F401
    sample_mesh_surface, sample_mesh_surface_with_normals,
)
