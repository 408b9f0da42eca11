"""Latent-space epsilon-prediction networks for the shape-latent DDPM.

Counterpart of the JAX package's `models/denoiser.py` (flax), as
`nn.Module`s whose submodule names are the flax scopes, so that
utils.checkpoint.denoiser_params_from_jax maps a flax tree onto the state
dict name for name. Dense layers are `nn.Linear` (weight [out, in]), the
LayerNorms use flax's eps 1e-6, and `out_proj` starts at zero as flax's
`kernel_init=zeros` does.

Conditioning (BASELINE.json:10): a class embedding (row `num_classes` is
the learned null token of classifier-free guidance) and a PointNet-style
partial-SDF encoder, both summed into the time embedding.

The 1-D conv UNet body (`arch="unet"`) keeps flax's channels-last signal
[B, tokens, C] only at its two ends: inside, every activation is
channels-first [B, C, tokens] as `nn.Conv1d` wants it. `padding="SAME"`
with kernel 3 is `padding=1`, `nn.avg_pool` (window 2, stride 2) is
`F.avg_pool1d(2)`, `jax.image.resize(..., "nearest")` to twice the length
repeats each token twice (`upsample_nearest2`), and the GroupNorms use
flax's eps 1e-6.
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


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C, 2T], each token twice (`jax.image.resize`
    "nearest" to twice the length; `repeat_interleave(2, -1)`). An expand
    and a reshape, so the backward is a sum, not an index_add."""
    return x[..., None].expand(*x.shape, 2).reshape(*x.shape[:-1], -1)


class ConvBlock1D(nn.Module):
    """GroupNorm(8) -> silu -> conv3 -> + cproj(cond) -> silu -> conv3, plus
    the input (through a 1x1 conv `cs` where the channels change).
    Channels-first: x [B, C_in, T], cond [B, D] -> [B, ch, T]."""

    def __init__(self, in_ch: int, ch: int, cond_dim: int):
        super().__init__()
        self.gn = nn.GroupNorm(8, in_ch, eps=LN_EPS)
        self.c1 = nn.Conv1d(in_ch, ch, 3, padding=1)
        self.cproj = nn.Linear(cond_dim, ch)
        self.c2 = nn.Conv1d(ch, ch, 3, padding=1)
        if in_ch != ch:
            self.cs = nn.Conv1d(in_ch, ch, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.c1(F.silu(self.gn(x)))
        h = self.c2(F.silu(h + self.cproj(cond)[:, :, None]))
        return (self.cs(x) if hasattr(self, "cs") else x) + h


class LatentDenoiserUNet(nn.Module):
    """1-D conv UNet over the latent viewed as (tokens, channels): the
    256-d latent is a (32, 8) signal, run through a 2-level down/up conv
    UNet with time/class conditioning (base width max(32, hidden_dim//8)),
    and flattened back. The `head` starts at zero."""

    def __init__(self, cfg: DenoiserConfig = DenoiserConfig(),
                 tokens: int = 32):
        super().__init__()
        self.cfg, self.tokens = cfg, tokens
        ch0 = cfg.latent_size // tokens
        base = max(32, cfg.hidden_dim // 8)
        d = cfg.hidden_dim
        self.cond = TimeCondEmbed(cfg)
        self.stem = nn.Conv1d(ch0, base, 3, padding=1)
        self.down1 = ConvBlock1D(base, base, d)
        self.down2 = ConvBlock1D(base, 2 * base, d)
        self.mid = ConvBlock1D(2 * base, 4 * base, d)
        self.up2 = ConvBlock1D(6 * base, 2 * base, d)
        self.up1 = ConvBlock1D(3 * base, base, d)
        self.head = nn.Conv1d(base, ch0, 3, padding=1)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, z_t: torch.Tensor, t: torch.Tensor,
                class_id: Optional[torch.Tensor] = None,
                partial_embed: Optional[torch.Tensor] = None,
                cond_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = z_t.shape[0]
        cond = self.cond(t, class_id, partial_embed, cond_drop)
        x = self.stem(z_t.reshape(B, self.tokens, -1).transpose(1, 2))
        d1 = self.down1(x, cond)
        d2 = self.down2(F.avg_pool1d(d1, 2), cond)
        x = self.mid(F.avg_pool1d(d2, 2), cond)
        x = self.up2(torch.cat([upsample_nearest2(x), d2], dim=1), cond)
        x = self.up1(torch.cat([upsample_nearest2(x), d1], dim=1), cond)
        return self.head(x).transpose(1, 2).reshape(B, self.cfg.latent_size)


def _body(cfg: DenoiserConfig) -> nn.Module:
    if cfg.arch == "mlp":
        return LatentDenoiserMLP(cfg)
    if cfg.arch == "unet":
        return LatentDenoiserUNet(cfg)
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
