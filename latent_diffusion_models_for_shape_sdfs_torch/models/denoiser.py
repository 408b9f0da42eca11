"""Latent-space epsilon-prediction networks for the shape-latent DDPM.

Counterpart of the JAX package's `models/denoiser.py` (flax), as
`nn.Module`s whose submodule names are the flax scopes, so that
utils.checkpoint.denoiser_params_from_jax maps a flax tree onto the state
dict name for name. Dense layers are `nn.Linear` (weight [out, in]), the
LayerNorms use flax's eps 1e-6, and `out_proj` starts at zero as flax's
`kernel_init=zeros` does.

Conditioning (BASELINE.json:10): a class embedding (row `num_classes` is
the learned null token of classifier-free guidance) and a PointNet-style
partial-SDF encoder, both summed into the time embedding. The 1-D conv
UNet body (`arch="unet"`) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch.config import DenoiserConfig

LN_EPS = 1e-6          # flax.linen.LayerNorm's default


def sinusoidal_time_embed(t: torch.Tensor, dim: int,
                          max_period: float = 10_000.0) -> torch.Tensor:
    """Standard DDPM sinusoidal embedding of integer timesteps. [B, dim]."""
    half = dim // 2
    log_period = torch.tensor(math.log(max_period), dtype=torch.float32)
    freqs = torch.exp(-log_period * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimeCondEmbed(nn.Module):
    """time (+ class + partial-SDF) -> one conditioning vector [B, D]."""

    def __init__(self, cfg: DenoiserConfig, partial_features: int = 256):
        super().__init__()
        self.cfg = cfg
        self.t1 = nn.Linear(cfg.time_embed_dim, cfg.hidden_dim)
        self.t2 = nn.Linear(cfg.hidden_dim, cfg.hidden_dim)
        if cfg.num_classes > 0:
            # row num_classes is the learned "null" (unconditional) token
            self.cls = nn.Embedding(cfg.num_classes + 1, cfg.hidden_dim)
        if cfg.partial_sdf_cond:
            self.partial_proj = nn.Linear(partial_features, cfg.hidden_dim)

    def forward(self, t: torch.Tensor, class_id: Optional[torch.Tensor],
                partial_embed: Optional[torch.Tensor],
                cond_drop: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        emb = self.t2(F.silu(self.t1(sinusoidal_time_embed(
            t, c.time_embed_dim))))
        if c.num_classes > 0:
            cid = (torch.full(t.shape, c.num_classes, dtype=torch.long,
                              device=t.device)
                   if class_id is None else class_id.long())
            if cond_drop is not None:
                cid = torch.where(cond_drop, c.num_classes, cid)
            emb = emb + self.cls(cid)
        if c.partial_sdf_cond and partial_embed is not None:
            emb = emb + self.partial_proj(partial_embed)
        return emb


class PartialSdfEncoder(nn.Module):
    """PointNet-style encoder: observed (xyz, sdf) samples -> [B, D], a max
    over points (masked points excluded; a set with no point gives 0)."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.pn0 = nn.Linear(4, 64)
        self.pn1 = nn.Linear(64, 128)
        self.pn2 = nn.Linear(128, features)

    def forward(self, obs_xyz: torch.Tensor, obs_sdf: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.cat([obs_xyz, obs_sdf[..., None]], dim=-1)   # [B,N,4]
        for layer in (self.pn0, self.pn1, self.pn2):
            x = F.relu(layer(x))
        if mask is not None:
            x = torch.where(mask[..., None], x, -torch.inf)
        x = torch.amax(x, dim=-2)                              # [B, features]
        return torch.where(torch.isfinite(x), x, 0.0)


class ResBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ln = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, width)
        self.fc2 = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.fc1(self.ln(x))
        return x + self.fc2(F.silu(h + cond))


class LatentDenoiserMLP(nn.Module):
    """eps_hat(z_t, t, cond): residual MLP over the latent."""

    def __init__(self, cfg: DenoiserConfig = DenoiserConfig()):
        super().__init__()
        self.cfg = cfg
        self.cond = TimeCondEmbed(cfg)
        self.in_proj = nn.Linear(cfg.latent_size, cfg.hidden_dim)
        for i in range(cfg.num_blocks):      # flax's scope names
            self.add_module(f"block{i}", ResBlock(cfg.hidden_dim))
        self.out_ln = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS)
        self.out_proj = nn.Linear(cfg.hidden_dim, cfg.latent_size)
        nn.init.zeros_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, z_t: torch.Tensor, t: torch.Tensor,
                class_id: Optional[torch.Tensor] = None,
                partial_embed: Optional[torch.Tensor] = None,
                cond_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        cond = self.cond(t, class_id, partial_embed, cond_drop)
        x = self.in_proj(z_t)
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block{i}")(x, cond)
        return self.out_proj(self.out_ln(x))


def _body(cfg: DenoiserConfig) -> nn.Module:
    if cfg.arch == "mlp":
        return LatentDenoiserMLP(cfg)
    if cfg.arch == "unet":
        raise NotImplementedError(
            "the UNet denoiser (arch='unet') is not ported yet; use "
            "arch='mlp'")
    raise ValueError(f"unknown denoiser arch {cfg.arch!r}")


class CondDenoiser(nn.Module):
    """Denoiser body + (optional) jointly trained partial-SDF encoder: raw
    observations go in, the encoder (when enabled) makes the conditioning
    embedding, the body predicts epsilon. One state dict."""

    def __init__(self, cfg: DenoiserConfig = DenoiserConfig()):
        super().__init__()
        self.cfg = cfg
        if cfg.partial_sdf_cond:
            self.partial_enc = PartialSdfEncoder()
        self.body = _body(cfg)

    def forward(self, z_t: torch.Tensor, t: torch.Tensor,
                class_id: Optional[torch.Tensor] = None,
                obs_xyz: Optional[torch.Tensor] = None,
                obs_sdf: Optional[torch.Tensor] = None,
                obs_mask: Optional[torch.Tensor] = None,
                cond_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        partial_embed = None
        if self.cfg.partial_sdf_cond and obs_xyz is not None:
            partial_embed = self.partial_enc(obs_xyz, obs_sdf, obs_mask)
            if cond_drop is not None:
                partial_embed = torch.where(cond_drop[..., None], 0.0,
                                            partial_embed)
        return self.body(z_t, t, class_id=class_id,
                         partial_embed=partial_embed, cond_drop=cond_drop)


def make_denoiser(cfg: DenoiserConfig) -> nn.Module:
    """The bare body (no partial-SDF encoder) for `cfg.arch`."""
    return _body(cfg)
