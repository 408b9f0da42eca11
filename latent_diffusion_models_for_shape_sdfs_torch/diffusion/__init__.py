"""Stage-2 latent diffusion: the noise schedule and the samplers."""
