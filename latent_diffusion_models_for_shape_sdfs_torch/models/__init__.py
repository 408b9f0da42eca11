from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (  # noqa: F401
    SdfDecoder, WNLinear, effective_weight)
