"""Per-shape learnable latent codes (the auto-decoder's 'embedding').

Counterpart of the JAX package's `models/latent_table.py` (SEMANTICS.md
section 3): init N(0, (std/sqrt(L))^2); one row gathered per scene; the
gradient is dense (autograd's index_select backward scatters into a
zero table), so untouched rows get exact zeros and still move through
Adam's m/v like the lineage's dense `torch.optim.Adam` over
`Embedding.weight`. Never use a sparse embedding gradient or SparseAdam
here: they would skip those rows. Optional max-norm projection at gather
time (lineage `Embedding(max_norm=code_bound)`).
"""

from __future__ import annotations

import torch


def init_latent_table(generator: torch.Generator, num_scenes: int,
                      latent_size: int, code_init_std: float = 1.0,
                      device="cpu") -> torch.Tensor:
    """[num_scenes, L] float32 codes drawn from `generator` (which must
    live on `device`)."""
    sigma = code_init_std / (latent_size ** 0.5)
    return sigma * torch.randn(num_scenes, latent_size, generator=generator,
                               device=device, dtype=torch.float32)


def gather_codes(codes: torch.Tensor, scene_ids: torch.Tensor,
                 code_bound: float = 0.0) -> torch.Tensor:
    """codes[scene_ids] with optional max-norm projection. [S, L]."""
    z = codes[scene_ids]
    if code_bound and code_bound > 0:
        norm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        z = z * torch.clamp(code_bound / torch.clamp(norm, min=1e-12),
                            max=1.0)
    return z
