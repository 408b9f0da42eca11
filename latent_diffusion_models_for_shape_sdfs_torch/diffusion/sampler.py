"""DDPM / DDIM / DPM-Solver++(2M) sampling of shape latents.

Counterpart of the JAX package's `diffusion/sampler.py`, step for step:
its `lax.scan` bodies are Python loops here, every per-step constant is
computed once up front as a float32 tensor on the schedule's device (so
the loop enqueues its work without waiting on the device), and randomness
comes from an explicit `torch.Generator` on that device instead of a JAX
key. Samplers take a `denoise_fn(z_t, t[B]) -> eps_hat` closure, so
conditioning and classifier-free guidance are the caller's composition
(`guided_denoise_fn`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _normal(generator: torch.Generator, shape: tuple,
            device: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def _tb(num: int, t: int, device) -> torch.Tensor:
    """The timestep of every latent of the batch, [num] int32, from a host
    integer: nothing reads the device, so `torch.export` traces the loop
    (each step's timestep is a constant of the program)."""
    return torch.full((num,), t, dtype=torch.int32, device=device)


@torch.no_grad()
def ddpm_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                generator: torch.Generator, num: int,
                latent_size: int) -> torch.Tensor:
    """Ancestral DDPM: z_T ~ N(0,I), T reverse steps. Returns z_0 [num, L]."""
    dev = schedule.device
    z = _normal(generator, (num, latent_size), dev)
    coef = schedule.betas / schedule.sqrt_one_minus_alpha_bars
    sqrt_alpha = torch.sqrt(schedule.alphas)
    sigma = torch.sqrt(schedule.posterior_var)
    for t in range(schedule.timesteps - 1, -1, -1):
        eps_hat = denoise_fn(z, _tb(num, t, dev))
        z = (z - coef[t] * eps_hat) / sqrt_alpha[t]
        if t > 0:
            z = z + sigma[t] * _normal(generator, z.shape, dev)
    return z


def ddim_timesteps(T: int, steps: int) -> torch.Tensor:
    """Strided subsequence t_i = (i*T)//steps, i = 0..steps-1 (ascending)."""
    return torch.tensor(_strided(T, steps), dtype=torch.int64)


def _strided(T: int, steps: int) -> list:
    """ddim_timesteps as host integers."""
    return [i * T // steps for i in range(steps)]


@torch.no_grad()
def ddim_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                generator: torch.Generator, num: int, latent_size: int,
                steps: int = 50, eta: float = 0.0,
                z_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM over a strided `steps`-subsequence; eta = 0 is deterministic
    given z_T (SEMANTICS.md section 6). Returns z_0 [num, L].

    `z_init` [num, L]: z_T (standard normal) given by the caller instead of
    drawn from `generator`. With eta > 0 every step adds
    sigma * N(0, I) drawn from `generator`."""
    dev = schedule.device
    z = (_normal(generator, (num, latent_size), dev) if z_init is None
         else z_init.to(device=dev, dtype=torch.float32))
    ts = _strided(schedule.timesteps, steps)
    abar = schedule.alpha_bars[torch.tensor(ts, device=dev)]
    abar_prev = torch.cat([torch.ones(1, device=dev), abar[:-1]])
    sqrt_1m = torch.sqrt(1.0 - abar)
    sqrt_a = torch.sqrt(abar)
    sigma = eta * torch.sqrt((1.0 - abar_prev) / (1.0 - abar)) * torch.sqrt(
        1.0 - abar / abar_prev)
    dir_coeff = torch.sqrt(torch.clamp(1.0 - abar_prev - sigma ** 2, min=0.0))
    sqrt_a_prev = torch.sqrt(abar_prev)
    for i in range(steps - 1, -1, -1):
        eps_hat = denoise_fn(z, _tb(num, ts[i], dev))
        z0_hat = (z - sqrt_1m[i] * eps_hat) / sqrt_a[i]
        z = sqrt_a_prev[i] * z0_hat + dir_coeff[i] * eps_hat
        if eta > 0:
            z = z + sigma[i] * _normal(generator, z.shape, dev)
    return z


@torch.no_grad()
def dpm_solver_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                      generator: torch.Generator, num: int,
                      latent_size: int, steps: int = 10,
                      z_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM-Solver++(2M): second-order multistep solver of the probability-
    flow ODE in the data-prediction form (Lu et al. 2022), on DDIM's
    strided timesteps, ending with a first-order step onto the clean
    manifold. Deterministic given z_T. Returns z_0 [num, L]."""
    dev = schedule.device
    z = (_normal(generator, (num, latent_size), dev) if z_init is None
         else z_init.to(device=dev, dtype=torch.float32))
    ts_desc = _strided(schedule.timesteps, steps)[::-1]
    abar = schedule.alpha_bars[torch.tensor(ts_desc, device=dev)]
    a_from = torch.sqrt(abar)
    s_from = torch.sqrt(1.0 - abar)
    a_to = torch.cat([a_from[1:], torch.ones(1, device=dev)])
    s_to = torch.cat([s_from[1:], torch.zeros(1, device=dev)])
    lam = torch.log(a_from / s_from)                     # half-logSNR
    # e^{-h_j} without forming the infinite final h: exactly 0 at the end
    exp_neg_h = (a_from * s_to) / (a_to * s_from)
    h = torch.cat([lam[1:], lam[-1:]]) - lam            # h[-1] unused
    # 2M correction weight h_j / (2 h_{j-1}); 0 for the first step (no
    # history) and the last (lower-order final step)
    c = torch.cat([torch.zeros(1, device=dev), h[1:] / (2.0 * h[:-1])])
    c[-1] = 0.0
    sigma_ratio = torch.where(s_from > 0, s_to / s_from, 0.0)
    x0_prev = torch.zeros_like(z)
    for j in range(steps):
        eps_hat = denoise_fn(z, _tb(num, ts_desc[j], dev))
        x0 = (z - s_from[j] * eps_hat) / a_from[j]
        d = (1.0 + c[j]) * x0 - c[j] * x0_prev
        z = sigma_ratio[j] * z - a_to[j] * (exp_neg_h[j] - 1.0) * d
        x0_prev = x0
    return z


def guided_denoise_fn(model: Callable, guidance_scale: float,
                      class_id: Optional[torch.Tensor] = None,
                      **cond_kwargs) -> DenoiseFn:
    """Compose a denoiser (models.denoiser.CondDenoiser) into a (possibly
    CFG-guided) DenoiseFn.

    `cond_kwargs` go to every call unchanged (obs_xyz / obs_sdf of the
    partial-SDF encoder; None values are dropped). guidance_scale 0, or no
    class: the plain conditional call. guidance_scale s > 0:
    eps = (1+s) * eps_cond - s * eps_uncond, where the unconditional call
    drops only the class (the null token) and keeps the observations."""
    cond_kwargs = {k: v for k, v in cond_kwargs.items() if v is not None}

    def fn(z_t, t):
        cond_eps = model(z_t, t, class_id=class_id, **cond_kwargs)
        if guidance_scale <= 0 or class_id is None:
            return cond_eps
        uncond_eps = model(z_t, t, class_id=None, **cond_kwargs)
        s = guidance_scale
        return (1.0 + s) * cond_eps - s * uncond_eps

    return fn
