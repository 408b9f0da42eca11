"""Stage-2 latent diffusion: code normalization.

Counterpart of `normalize_codes` / `unnormalize_codes` of the JAX
package's `train/diffusion.py`. The stage-2 trainer itself is not ported
yet.
"""

from __future__ import annotations

import torch


def normalize_codes(codes: torch.Tensor, eps: float = 1e-6) -> tuple:
    """Per-dim standardization of the frozen latent table. Returns
    (normed [N,L], mu [L], sigma [L]); sigma is the population std
    (`jnp.std`'s ddof 0), floored at eps."""
    mu = codes.mean(dim=0)
    sigma = torch.clamp(codes.std(dim=0, correction=0), min=eps)
    return (codes - mu) / sigma, mu, sigma


def unnormalize_codes(z: torch.Tensor, mu: torch.Tensor,
                      sigma: torch.Tensor) -> torch.Tensor:
    return z * sigma + mu
