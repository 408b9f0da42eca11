"""Plain reference of the conditioned latent denoiser and its stage-2
training step, in float32 PyTorch (TF32 off unless the control asks).

The network (a DDPM eps-predictor over 256-wide shape latents, as the
configuration's `diff.denoiser` states): a PointNet encoder of the
observed (xyz, sdf) points (4 -> 64 -> 128 -> 256, relu, max over points),
a sinusoidal time embedding through two dense layers with silu, a class
embedding whose last row is the null token, all summed into one
conditioning vector; the latent's input projection, residual blocks
x + fc2(silu(fc1(layernorm(x)) + cond)), a final layernorm and output
projection. Classifier-free dropout swaps in the null class and zeroes
the observation embedding. The step: q_sample, eps-MSE, Adam, then the
EMA. Parameters are given by name, in nn.Linear's [out, in] layout.
Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

LN_EPS = 1e-6


def schedule(T: int, beta_start: float, beta_end: float, device) -> tuple:
    """(sqrt(abar), sqrt(1 - abar)) of the linear beta schedule, computed
    in float64 and rounded once to float32."""
    betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    abar = np.cumprod(1.0 - betas)
    return (torch.from_numpy(np.sqrt(abar)).float().to(device),
            torch.from_numpy(np.sqrt(1.0 - abar)).float().to(device))


def _dense(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _ln(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def time_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(p: dict, den: dict, z_t, t, class_id, obs_xyz, obs_sdf,
            drop) -> torch.Tensor:
    cond = _dense(p, "body.cond.t2", F.silu(_dense(
        p, "body.cond.t1", time_embed(t, den["time_embed_dim"]))))
    if den["num_classes"] > 0:
        cid = torch.where(drop, den["num_classes"], class_id)
        cond = cond + p["body.cond.cls.weight"][cid]
    if den["partial_sdf_cond"]:
        x = torch.cat([obs_xyz, obs_sdf[..., None]], dim=-1)
        for k in ("pn0", "pn1", "pn2"):
            x = torch.relu(_dense(p, f"partial_enc.{k}", x))
        emb = torch.amax(x, dim=-2)
        emb = torch.where(drop[:, None], 0.0, emb)
        cond = cond + _dense(p, "body.cond.partial_proj", emb)
    x = _dense(p, "body.in_proj", z_t)
    for i in range(den["num_blocks"]):
        b = f"body.block{i}"
        h = _dense(p, f"{b}.fc1", _ln(p, f"{b}.ln", x))
        x = x + _dense(p, f"{b}.fc2", F.silu(h + cond))
    return _dense(p, "body.out_proj", _ln(p, "body.out_ln", x))


def train_steps(params: dict, diff: dict, codes_n, class_ids, obs_xyz,
                obs_sdf, draws: list, tf32: bool = False) -> dict:
    """The reference's steps from `params` over `draws` (per step: idx,
    t, eps, drop, cols): each step's loss, the first step's gradients, the
    leaves and the EMA after the last step."""
    den = diff["denoiser"]
    dev = codes_n.device
    a, b = schedule(diff["timesteps"], diff["beta_start"], diff["beta_end"],
                    dev)
    leaves = {k: v.detach().clone().float() for k, v in params.items()}
    ema = {k: v.clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    b1, b2, eps_, lr, d = 0.9, 0.999, 1e-8, diff["lr"], diff["ema_decay"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    losses, first = [], None
    try:
        for k, dr in enumerate(draws, start=1):
            idx, t, eps = dr["idx"], dr["t"], dr["eps"]
            z_t = a[t][:, None] * codes_n[idx] + b[t][:, None] * eps
            ox, od = obs_xyz[idx], obs_sdf[idx]
            if "cols" in dr:
                ox = torch.gather(ox, 1, dr["cols"][..., None].expand(-1, -1,
                                                                       3))
                od = torch.gather(od, 1, dr["cols"])
            p = {n: x.requires_grad_(True) for n, x in leaves.items()}
            out = forward(p, den, z_t, t, class_ids[idx], ox, od, dr["drop"])
            loss = torch.mean((out - eps) ** 2)
            grads = torch.autograd.grad(loss, list(p.values()))
            g = dict(zip(p, grads))
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: x.clone() for n, x in g.items()}
            with torch.no_grad():
                for n in leaves:
                    leaves[n] = leaves[n].detach()
                    m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                    v2[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                    denom = v2[n].sqrt() / math.sqrt(1 - b2 ** k) + eps_
                    leaves[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** k))
                    ema[n].mul_(d).add_(leaves[n], alpha=1 - d)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"losses": losses, "grad1": first, "leaves": leaves, "ema": ema}
