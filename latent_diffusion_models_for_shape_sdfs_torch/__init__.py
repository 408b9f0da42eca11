"""PyTorch + CUDA port of the latent-diffusion-for-shape-SDFs framework.

The JAX package `latent_diffusion_models_for_shape_sdfs_tpu` beside it is
the reference; this package keeps its module names so each counterpart is
easy to find, and imports neither JAX nor that package. Entry points run
on `cuda` unless the caller passes `device="cpu"`.

Ported so far. The serving path: `config`, `models.decoder`,
`utils.checkpoint`, `ops.fused_decoder`, `ops.cuda_kernels` (the fused
decoder-eval CUDA kernel, `csrc/fused_eval.cu`), `ops.grid_eval`,
`ops.isosurface`, `evaluation`, `utils.meshio` and `serve`. Stage-1
training: `losses`, `models.latent_table`, `data.analytic`,
`data.sdf_dataset`, `utils.logging`, `ops.relu_dropout` (the relu+dropout
kernel pair, `csrc/relu_dropout.cu`), `ops.fused_train` (the fused train
kernel, `csrc/fused_train.cu`), `ops.head` (the bf16 decoder's fp32 head
on the card, `csrc/head.cu`) and `train.auto_decoder`. Config 4's
generation: `diffusion.schedule`, `diffusion.sampler`, `models.denoiser`,
`serve.generate_meshes`, and the flat batched decode in `ops.grid_eval`
with the per-point-latent eval kernel
(`ops.cuda_kernels.make_kernel_apply_pairs`, `csrc/fused_eval_pairs.cu`).
The main path `train-ad -> train-diff -> sample -> eval`: `train.diffusion`
(stage-2 training, one CUDA graph a step on a card), the stage
checkpoints of `utils.checkpoint`, `pipeline` and `cli` (`python -m
latent_diffusion_models_for_shape_sdfs_torch`). Reconstruction from
observations: `reconstruct` (latent optimisation, one CUDA graph a step
on a card, with restarts and the diffusion prior), `models.encoder` and
`train.encoder` (the amortized encoder), `data.analytic_device` (chairs
sampled on the device), `train.graph` (the capture the graphed loops
share); and config 2-unet's UNet body in `models.denoiser`. Real meshes
and read-outs: `utils.meshio` (readers, winding, vertex normals),
`SdfDataset.from_dir` (the `sdf:<dir>` source of `cli preprocess`),
`ops.render` (sphere-traced previews through kernel #1) and
`utils.image`, latent interpolation, `evaluation.generative` and
`evaluation.device_metrics` (MMD / COV / 1-NNA over Chamfer and
Sinkhorn-EMD), and the rest of `ops.grid_eval` (the batched and
device-resident hierarchical decodes). Stage 1 from the on-device sample
bank and data parallel: `data.device_bank`, the chair and CSG bank
producers of `data.analytic_device`, and `parallel` (the data mesh and
the data-parallel steps over `torch.distributed`). Serving artifacts and
decoding on several ranks: `export_artifact` (`torch.export` programs of
the decode and the sampler; `ops.fused_eval_op` makes the decoder-eval
kernel the custom op `sdfldm::fused_eval` they call), the decode half of
`parallel.dp` and `serve.serve_meshes_sharded`.
"""
