"""Test-time latent inference: optimise a latent code against observations.

Counterpart of the JAX package's `reconstruct.py`. Given a frozen decoder
and observed (xyz, sdf) samples of an unseen or partial shape, minimise

    clamped_l1(decoder(z, xyz), sdf) + (1/sigma^2) ||z||^2 / n

over z with optax's `scale_by_adam(0.9, 0.999, 1e-8)` (eps outside the
square root) and `z -= lr * update`, lr `cfg.lr` before `lr_decay_at` and
a tenth of it from then on; `cfg.num_inits` restarts are one [k, L]
tensor whose losses are summed, so each row keeps its own gradient.
`reconstruct_latent_diffusion_prior` adds a score-distillation gradient
from a trained stage-2 denoiser.

The reference runs the whole optimisation as one `lax.scan`. Here it is
`LatentOpt`: the step reads its rate, its prior draws and its row of the
loss histories at a device-side step counter from static buffers, so on a
card the run is one captured CUDA graph replayed `num_steps` times
(train.graph.capture_step; a failed capture raises) and the host waits
once, when it reads the histories; on the CPU the same step runs eagerly.
The decoder is frozen for the step (`requires_grad_(False)`, eval mode;
both put back after it): autograd differentiates with respect to z alone
and builds no weight gradient. The
random streams are torch's: z0 from a generator seeded with `seed`
(default cfg.seed), the prior's noise (and its timesteps, without
annealing) from one seeded off it, drawn up front (`draw_recon`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch.config import (
    ReconstructConfig)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
    chunk_seed)
from latent_diffusion_models_for_shape_sdfs_torch.train.graph import (
    capture_step)

B1, B2, EPS = 0.9, 0.999, 1e-8       # optax.scale_by_adam
SDS_TAG = 0x5D5                      # the prior's stream, off the z0 seed
# captured steps a cache keeps: each holds a graph and its private memory
# pool (the forward's saved activations over n points), so a daemon fed
# ever new observation counts keeps the latest few, not every one
CACHE_SIZE = 4


@contextlib.contextmanager
def _frozen(decoder: SdfDecoder) -> Iterator[None]:
    """The decoder without parameter gradients and in eval mode; puts back
    each parameter's `requires_grad` and the module's mode."""
    grads = [p.requires_grad for p in decoder.parameters()]
    training = decoder.training
    decoder.requires_grad_(False)
    decoder.eval()
    try:
        yield
    finally:
        for p, g in zip(decoder.parameters(), grads):
            p.requires_grad_(g)
        decoder.train(training)


def sds_timesteps(num_steps: int, T: int, t_lo: float,
                  t_hi: float) -> np.ndarray:
    """The annealed prior's timestep at each step, t_hi -> t_lo linearly
    (the reference's float32 arithmetic): int(tf * T) clipped to [0, T)."""
    frac = (np.arange(num_steps, dtype=np.float32)
            / np.float32(max(num_steps - 1, 1)))
    tf = np.float32(t_hi) + np.float32(t_lo - t_hi) * frac
    return np.clip((tf * np.float32(T)).astype(np.int32), 0, T - 1)


def draw_recon(cfg: ReconstructConfig, k: int, L: int, device,
               seed: Optional[int] = None,
               sds_prior: Optional[dict] = None) -> dict:
    """A run's randomness on `device`: `z0 [k, L]` (init_std * N(0, 1))
    from a generator seeded with `seed` (default cfg.seed); with a prior,
    its noise `eps [num_steps, k, L]` and, unless it anneals, its
    timesteps `t [num_steps]` (U[t_lo, t_hi) * T, truncated) from a
    generator seeded off it."""
    dev = torch.device(device)
    seed = cfg.seed if seed is None else seed
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {"z0": cfg.init_std * torch.randn((k, L), generator=gen,
                                            device=dev)}
    if sds_prior is not None:
        sgen = torch.Generator(device=dev).manual_seed(
            chunk_seed(seed, SDS_TAG))
        S = cfg.num_steps
        out["eps"] = torch.randn((S, k, L), generator=sgen, device=dev)
        if not sds_prior["anneal"]:
            lo, hi = float(sds_prior["t_lo"]), float(sds_prior["t_hi"])
            tf = lo + (hi - lo) * torch.rand((S,), generator=sgen,
                                             device=dev)
            T = sds_prior["sched"].timesteps
            out["t"] = torch.clamp((tf * T).long(), 0, T - 1)
    return out


class LatentOpt:
    """One latent optimisation of k rows over `cfg.num_steps` steps, eager
    or as a captured CUDA graph a step.

    Observations: `obs_rows` sets of n points (1: every row sees the same
    set, as restarts do; k: row i sees set i, as the batched
    reconstruction does). `sds_prior` (weight > 0) adds the prior's
    gradient. After a run, `z [k, L]`, `hist [num_steps, k]` (loss) and
    `l1 [num_steps, k]` (data term) hold the result, on the decoder's
    device. One instance serves any number of runs of its shapes (`load`,
    then `eager` or `graphed`, which raise without a fresh `load`); the
    graph is captured once. The decoder is frozen only while a step runs
    (or is captured)."""

    def __init__(self, decoder: SdfDecoder, cfg: ReconstructConfig, k: int,
                 n: int, obs_rows: int = 1,
                 sds_prior: Optional[dict] = None):
        self.decoder, self.cfg, self.k, self.n = decoder, cfg, k, n
        self.sds = sds_prior
        dev = next(decoder.parameters()).device
        L, S = decoder.cfg.latent_size, cfg.num_steps
        f32 = dict(dtype=torch.float32, device=dev)
        self.xyz = torch.zeros((obs_rows, n, 3), **f32)
        self.sdf = torch.zeros((obs_rows, n), **f32)
        self.z = torch.zeros((k, L), requires_grad=True, **f32)
        self.m = torch.zeros((k, L), **f32)
        self.v = torch.zeros((k, L), **f32)
        self.count = torch.zeros((), **f32)
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)
        self.hist = torch.zeros((S, k), **f32)
        self.l1 = torch.zeros((S, k), **f32)
        lr = np.where(np.arange(S) < cfg.lr_decay_at, np.float32(cfg.lr),
                      np.float32(cfg.lr * 0.1)).astype(np.float32)
        self.lr = torch.from_numpy(lr).to(dev)
        if sds_prior is not None:
            self.eps = torch.zeros((S, k, L), **f32)
            self.t = torch.zeros(S, dtype=torch.long, device=dev)
            if sds_prior["anneal"]:
                self.t.copy_(torch.from_numpy(sds_timesteps(
                    S, sds_prior["sched"].timesteps, sds_prior["t_lo"],
                    sds_prior["t_hi"])))
            self.s_mu = torch.as_tensor(sds_prior["mu"], **f32)
            self.s_sigma = torch.as_tensor(sds_prior["sigma"], **f32)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.loaded = False

    def load(self, obs_xyz, obs_sdf, draws: dict,
             z_init: Optional[torch.Tensor] = None) -> None:
        """Observations ([n, 3] / [n], or [obs_rows, n, 3] / [obs_rows, n]),
        a run's draws (`draw_recon`) and an optional warm start `z_init`
        [L] (row 0 starts at z_init, the others at z_init + z0's jitter)
        into the static buffers; resets the optimiser."""
        dev = self.z.device
        with torch.no_grad():
            self.xyz.copy_(torch.as_tensor(obs_xyz, dtype=torch.float32,
                                           device=dev).reshape(
                                               self.xyz.shape))
            self.sdf.copy_(torch.as_tensor(obs_sdf, dtype=torch.float32,
                                           device=dev).reshape(
                                               self.sdf.shape))
            z0 = draws["z0"]
            if z_init is not None:
                z0 = z0.clone()
                z0[0] = 0.0
                z0 = torch.as_tensor(z_init, dtype=torch.float32,
                                     device=dev)[None] + z0
            self.z.copy_(z0)
            if self.sds is not None:
                self.eps.copy_(draws["eps"])
                if not self.sds["anneal"]:
                    self.t.copy_(draws["t"])
            for b in (self.m, self.v, self.count, self.counter):
                b.zero_()
        self.loaded = True

    def _step(self) -> None:
        c, k, n = self.cfg, self.k, self.n
        z = self.z
        L = z.shape[1]
        with torch.enable_grad(), _frozen(self.decoder):
            pred = self.decoder(z[:, None, :].expand(k, n, L),
                                self.xyz.expand(k, n, 3))        # [k, n]
            d = c.clamp_dist
            l1 = torch.sum(torch.abs(torch.clamp(pred, -d, d)
                                     - torch.clamp(self.sdf, -d, d)),
                           dim=-1) / n
            reg = (1.0 / c.code_reg_sigma ** 2) * torch.sum(z * z, -1) / n
            loss = l1 + reg
            g, = torch.autograd.grad(loss.sum(), z)
        with torch.no_grad():
            j = self.counter
            if self.sds is not None:
                # score distillation: diffuse the normalized code, and pull
                # z toward the learned distribution (the denoiser Jacobian
                # is skipped; 1/sigma is the chain rule through the
                # normalization)
                sp = self.sds
                t = self.t.index_select(0, j).expand(k)
                eps = self.eps.index_select(0, j)[0]
                z_n = (z - self.s_mu) / self.s_sigma
                z_t = sp["sched"].q_sample(z_n, t, eps)
                eps_hat = sp["denoise_fn"](z_t, t)
                g = g + float(sp["weight"]) * (eps_hat - eps) / self.s_sigma
            self.count += 1.0
            self.m.copy_((1.0 - B1) * g + B1 * self.m)
            self.v.copy_((1.0 - B2) * (g * g) + B2 * self.v)
            m_hat = self.m / (1.0 - torch.pow(B1, self.count))
            v_hat = self.v / (1.0 - torch.pow(B2, self.count))
            upd = m_hat / (torch.sqrt(v_hat) + EPS)
            z.sub_(self.lr.index_select(0, j) * upd)
            self.hist.index_copy_(0, j, loss.detach()[None])
            self.l1.index_copy_(0, j, l1.detach()[None])
            self.counter += 1

    def _start(self) -> None:
        # a run past num_steps would index the step's tables out of range
        if not self.loaded:
            raise RuntimeError("LatentOpt: load() a run before each run")
        self.loaded = False

    def eager(self) -> None:
        """Run the loaded optimisation step by step."""
        self._start()
        for _ in range(self.cfg.num_steps):
            self._step()

    def graphed(self) -> None:
        """The same steps by replaying the captured graph (captured on the
        first call)."""
        self._start()
        if self.graph is None:
            self.graph = capture_step(
                self._step, [self.z, self.m, self.v, self.count,
                             self.counter, self.hist, self.l1])
        for _ in range(self.cfg.num_steps):
            self.graph.replay()

    def run(self) -> None:
        """Graphed on a card, eager on the CPU."""
        if self.z.device.type == "cuda":
            self.graphed()
        else:
            self.eager()


def _opt_for(decoder, cfg, k, n, sp, cache) -> LatentOpt:
    """The LatentOpt of these shapes and this prior, from `cache` (a dict
    the caller keeps, keyed by (k, n, cfg, the prior dict's id), least
    recently used first) when one is given. An entry keeps its prior dict
    alive, so the id is not reused while the entry lives. A new entry
    beyond CACHE_SIZE evicts the least recently used one and returns its
    graph's memory to the card."""
    if cache is None:
        return LatentOpt(decoder, cfg, k, n, 1, sp)
    key = (k, n, cfg, None if sp is None else id(sp))
    opt = cache.pop(key, None)
    if opt is None or opt.sds is not sp:
        while len(cache) >= CACHE_SIZE:
            del cache[next(iter(cache))]      # frees its graph and buffers
            torch.cuda.empty_cache()          # a no-op without a card
        opt = LatentOpt(decoder, cfg, k, n, 1, sp)
    cache[key] = opt
    return opt


def reconstruct_latent(decoder: SdfDecoder, obs_xyz, obs_sdf,
                       cfg: ReconstructConfig = ReconstructConfig(),
                       seed: Optional[int] = None, z_init=None,
                       sds_prior: Optional[dict] = None,
                       draws: Optional[dict] = None,
                       cache: Optional[dict] = None) -> tuple:
    """Optimise one latent against observations obs_xyz [n, 3] / obs_sdf
    [n] on the decoder's device. Returns (z [L], info).

    cfg.num_inits > 1 runs that many restarts at once and returns the one
    with the lowest final data term. `z_init` [L] warm-starts (restart 0
    exactly at z_init). `sds_prior` (keys `denoise_fn`, `sched`, `mu`,
    `sigma`, `weight`, `t_lo`, `t_hi`, `anneal`; see
    reconstruct_latent_diffusion_prior) adds the prior's gradient; with
    weight 0 (or None) the run is the plain MAP one. `draws` replaces
    `draw_recon`'s. `cache` (a dict the caller keeps) reuses the captured
    step of earlier runs of the same shapes (k, n, cfg) and the same
    prior dict; it keeps the CACHE_SIZE latest. `info` holds loss_first,
    loss_last, l1_last, steps, num_inits and the chosen row's histories
    `loss_hist` / `l1_hist` (numpy)."""
    sp = (sds_prior if sds_prior is not None
          and sds_prior.get("weight", 0.0) > 0.0 else None)
    dev = next(decoder.parameters()).device
    k = max(1, cfg.num_inits)
    n = int(torch.as_tensor(obs_sdf).shape[0])
    opt = _opt_for(decoder, cfg, k, n, sp, cache)
    if draws is None:
        draws = draw_recon(cfg, k, decoder.cfg.latent_size, dev, seed, sp)
    opt.load(obs_xyz, obs_sdf, draws, z_init)
    opt.run()
    best = torch.argmin(opt.l1[-1])[None]
    z = opt.z.detach().index_select(0, best)[0]
    hist, l1 = torch.stack([opt.hist.index_select(1, best)[:, 0],
                            opt.l1.index_select(1, best)[:, 0]]).cpu().numpy()

    info = {"loss_first": float(hist[0]), "loss_last": float(hist[-1]),
            "l1_last": float(l1[-1]), "steps": cfg.num_steps,
            "num_inits": k, "loss_hist": hist, "l1_hist": l1}
    return z.clone(), info


def reconstruct_latent_diffusion_prior(
        decoder: SdfDecoder, obs_xyz, obs_sdf, denoise_fn, sched, mu, sigma,
        cfg: ReconstructConfig = ReconstructConfig(),
        seed: Optional[int] = None, sds_weight: float = 1e-3,
        t_lo: float = 0.02, t_hi: float = 0.98, anneal: bool = True,
        z_init=None, draws: Optional[dict] = None,
        cache: Optional[dict] = None) -> tuple:
    """Latent optimisation with a trained stage-2 denoiser as the prior:
    each step diffuses the normalized code to a timestep t with noise eps
    and adds sds_weight * (eps_hat(z_t, t) - eps) / sigma to the data
    gradient. `denoise_fn(z_t [k, L], t [k]) -> eps_hat` (e.g.
    `diffusion.sampler.guided_denoise_fn` over the EMA weights), `sched`
    a DiffusionSchedule, `mu`/`sigma` the stage-2 code moments.
    `anneal=True` sweeps t linearly t_hi -> t_lo; False draws t ~ U[t_lo,
    t_hi). With sds_weight 0 this is exactly `reconstruct_latent`.
    Returns (z [L], info) with `sds_weight` in info."""
    z, info = reconstruct_latent(
        decoder, obs_xyz, obs_sdf, cfg=cfg, seed=seed, z_init=z_init,
        sds_prior={"denoise_fn": denoise_fn, "sched": sched, "mu": mu,
                   "sigma": sigma, "weight": sds_weight, "t_lo": t_lo,
                   "t_hi": t_hi, "anneal": anneal},
        draws=draws, cache=cache)
    return z, {**info, "sds_weight": sds_weight}


def reconstruct_latent_batch(decoder: SdfDecoder, obs_xyz, obs_sdf,
                             cfg: ReconstructConfig = ReconstructConfig(),
                             seed: Optional[int] = None,
                             draws: Optional[dict] = None) -> torch.Tensor:
    """Independent reconstructions of a batch of shapes: obs_xyz [B, n, 3],
    obs_sdf [B, n] -> z [B, L] (row i optimised against set i from its
    own z0; no restarts)."""
    B, n = int(obs_sdf.shape[0]), int(obs_sdf.shape[1])
    dev = next(decoder.parameters()).device
    bcfg = dataclasses.replace(cfg, num_inits=1)
    opt = LatentOpt(decoder, bcfg, B, n, obs_rows=B)
    if draws is None:
        draws = draw_recon(bcfg, B, decoder.cfg.latent_size, dev, seed)
    opt.load(obs_xyz, obs_sdf, draws)
    opt.run()
    return opt.z.detach().clone()
