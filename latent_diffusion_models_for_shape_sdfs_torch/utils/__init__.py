from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling as profiling  # noqa: F401
