"""Data parallelism over torch.distributed: the data mesh (mesh.py) and
the data-parallel stage-1 steps (dp.py)."""

from latent_diffusion_models_for_shape_sdfs_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DataMesh, batch_sharded, make_mesh, make_mesh_2level)
from latent_diffusion_models_for_shape_sdfs_torch.parallel.dp import (  # noqa: F401
    make_dp_ad_train_step, make_dp_bank_step)
