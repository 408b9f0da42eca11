"""Training loops (stage 1: the auto-decoder; stage 2: the diffusion
model; the amortized encoder) and the CUDA-graph capture they share."""
