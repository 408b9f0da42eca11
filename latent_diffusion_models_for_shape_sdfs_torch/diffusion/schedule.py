"""DDPM noise schedule and closed-form q/posterior quantities.

Counterpart of the JAX package's `diffusion/schedule.py`: a linear beta
schedule (SEMANTICS.md section 6), beta = linspace(1e-4, 0.02, T), with
every derived array precomputed as float32 on an explicit device.

The schedule is computed on the host in the arithmetic that the JAX
package's CPU program uses (XLA's rewrite of `linspace`, its blocked
`cumprod`, correctly rounded square roots), then moved to the device, so the CPU parity tests see the
reference's own bits and a run on the card starts from the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """jnp.linspace(start, stop, num, dtype=float32) as XLA's CPU code
    evaluates it: step = i * f32(1/(num-1)); start*(1-step) rounded, plus
    i * f32(stop/(num-1)) in one fused multiply-add; the endpoint is
    `stop` itself."""
    f32 = torch.float32
    lo, hi = torch.tensor(start, dtype=f32), torch.tensor(stop, dtype=f32)
    if num == 1:
        return lo[None]
    r = torch.tensor(1.0, dtype=f32) / (num - 1)
    it = torch.arange(num - 1, dtype=f32)
    a = lo * (1.0 - it * r)
    fma = a.double() + it.double() * (hi * r).double()   # exact product
    return torch.cat([fma.to(f32), hi[None]])


def _cumprod(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive float32 cumprod in the order of XLA's CPU scan: sequential
    within blocks of 16, each block scaled by the (recursively scanned)
    product of the blocks before it."""
    n = x.shape[0]
    if n <= block:
        out = x.clone()
        for i in range(1, n):
            out[i] = out[i - 1] * x[i]
        return out
    nb = -(-n // block)
    inb = torch.ones(nb * block, dtype=x.dtype)
    inb[:n] = x
    inb = inb.reshape(nb, block)
    for i in range(1, block):
        inb[:, i] = inb[:, i - 1] * inb[:, i]
    tot = _cumprod(inb[:, -1].clone(), block)
    pre = torch.cat([torch.ones(1, dtype=x.dtype), tot[:-1]])
    return (pre[:, None] * inb).reshape(-1)[:n]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's vectorised CPU sqrt can be
    an ulp off; the float64 root rounds correctly to float32)."""
    return torch.sqrt(x.double()).float()


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor                      # [T]
    alphas: torch.Tensor                     # [T]
    alpha_bars: torch.Tensor                 # [T]  prod_{s<=t} alpha_s
    alpha_bars_prev: torch.Tensor            # [T]  abar_{t-1}, abar_{-1} = 1
    sqrt_alpha_bars: torch.Tensor            # [T]
    sqrt_one_minus_alpha_bars: torch.Tensor  # [T]
    posterior_var: torch.Tensor              # [T]  beta_t (1-abar_{t-1})/(1-abar_t)

    @property
    def timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device

    @classmethod
    def create(cls, timesteps: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 0.02, device="cuda") -> "DiffusionSchedule":
        """The schedule's float32 arrays on `device` (default "cuda",
        which raises when no card is present; pass "cpu" for the CPU)."""
        dev = resolve_device(device)
        betas = _linspace(beta_start, beta_end, timesteps)
        alphas = 1.0 - betas
        abar = _cumprod(alphas)
        abar_prev = torch.cat([torch.ones(1), abar[:-1]])
        post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
        arrays = (betas, alphas, abar, abar_prev, _sqrt(abar),
                  _sqrt(1.0 - abar), post_var)
        return cls(*(a.to(dev) for a in arrays))

    def q_sample(self, z0: torch.Tensor, t: torch.Tensor,
                 eps: torch.Tensor) -> torch.Tensor:
        """z_t = sqrt(abar_t) z0 + sqrt(1-abar_t) eps; t broadcasts [B]."""
        a = self.sqrt_alpha_bars[t][..., None]
        b = self.sqrt_one_minus_alpha_bars[t][..., None]
        return a * z0 + b * eps

    def predict_z0(self, z_t: torch.Tensor, t: torch.Tensor,
                   eps_hat: torch.Tensor) -> torch.Tensor:
        a = self.sqrt_alpha_bars[t][..., None]
        b = self.sqrt_one_minus_alpha_bars[t][..., None]
        return (z_t - b * eps_hat) / a
