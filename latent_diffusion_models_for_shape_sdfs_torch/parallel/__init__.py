"""Data parallelism over torch.distributed: the data mesh (mesh.py), the
data-parallel stage-1 steps, sampling and decodes (dp.py)."""

from latent_diffusion_models_for_shape_sdfs_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DataMesh, batch_sharded, make_mesh, make_mesh_2level)
from latent_diffusion_models_for_shape_sdfs_torch.parallel.dp import (  # noqa: F401
    all_gather_rows, decode_grid_sharded, decode_points_sharded,
    dp_ddim_sample, make_decode_points_fn, make_dp_ad_train_step,
    make_dp_bank_step, make_dp_ddim_fn, make_dp_pairs_fn,
    make_dp_sparse_decode_fn)
