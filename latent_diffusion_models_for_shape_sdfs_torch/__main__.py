from latent_diffusion_models_for_shape_sdfs_torch.cli import main

main()
