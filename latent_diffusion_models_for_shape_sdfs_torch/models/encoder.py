"""Amortized latent encoder: (xyz, sdf) observations -> latent code.

Counterpart of the JAX package's `models/encoder.py` (flax), with the flax
scope names as submodule names (`pt{i}`, `ln{i}`, `hd{i}`, `out`), so that
utils.checkpoint.encoder_params_from_jax maps a flax tree onto the state
dict name for name. A permutation-invariant PointNet-style set encoder
trained (train/encoder.py) to regress the stage-1 latent table from
observation subsets: one forward pass gives a one-shot reconstruction, or
a warm start for latent optimisation (reconstruct.reconstruct_latent's
`z_init`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch.config import EncoderConfig
from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
    LN_EPS)


class LatentEncoder(nn.Module):
    """Per-point MLP (Dense -> LayerNorm -> silu, widths
    cfg.point_widths), then the masked max and mean over the points,
    concatenated, then an MLP head (Dense -> silu, cfg.head_widths) and a
    zero-initialised `out` to cfg.latent_size. The output is a NORMALIZED
    code (train/encoder.py standardizes the table per dimension)."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.cfg = cfg
        w_in = 4
        for i, w in enumerate(cfg.point_widths):
            self.add_module(f"pt{i}", nn.Linear(w_in, w))
            self.add_module(f"ln{i}", nn.LayerNorm(w, eps=LN_EPS))
            w_in = w
        w_in *= 2
        for i, w in enumerate(cfg.head_widths):
            self.add_module(f"hd{i}", nn.Linear(w_in, w))
            w_in = w
        self.out = nn.Linear(w_in, cfg.latent_size)
        nn.init.zeros_(self.out.weight)
        nn.init.zeros_(self.out.bias)

    def forward(self, obs_xyz: torch.Tensor, obs_sdf: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """obs_xyz [B,N,3], obs_sdf [B,N], mask [B,N] bool -> [B, L]. A row
        with no point unmasked pools to 0 (max) and 0 (mean)."""
        x = torch.cat([obs_xyz, obs_sdf[..., None]], dim=-1)
        for i in range(len(self.cfg.point_widths)):
            x = F.silu(getattr(self, f"ln{i}")(getattr(self, f"pt{i}")(x)))
        if mask is None:
            mx = torch.amax(x, dim=-2)
            mn = torch.mean(x, dim=-2)
        else:
            m = mask[..., None]
            mx = torch.amax(torch.where(m, x, -torch.inf), dim=-2)
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
            cnt = torch.clamp(torch.sum(m, dim=-2), min=1)
            mn = torch.sum(torch.where(m, x, 0.0), dim=-2) / cnt
        h = torch.cat([mx, mn], dim=-1)
        for i in range(len(self.cfg.head_widths)):
            h = F.silu(getattr(self, f"hd{i}")(h))
        return self.out(h)


def encode_latent(encoder: LatentEncoder, obs_xyz: torch.Tensor,
                  obs_sdf: torch.Tensor, mu: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
    """One-shot latent prediction in TABLE space for one observation set:
    obs_xyz [N,3], obs_sdf [N] -> z [L] = encoder(...) * sigma + mu, with
    the encoder checkpoint's code moments mu/sigma, on the encoder's
    device."""
    dev = next(encoder.parameters()).device
    with torch.no_grad():
        z_n = encoder(torch.as_tensor(obs_xyz, dtype=torch.float32,
                                      device=dev)[None],
                      torch.as_tensor(obs_sdf, dtype=torch.float32,
                                      device=dev)[None])[0]
    return z_n * sigma.to(dev) + mu.to(dev)
