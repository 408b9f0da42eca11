"""Stage-2 latent diffusion training over the frozen stage-1 latent table.

Counterpart of the JAX package's `train/diffusion.py` (SEMANTICS.md
section 6). The reference runs `scan_chunk` steps as one compiled
`lax.scan` with no host round trip and logs between chunks. Here a chunk
is:
  * its randomness, drawn up front in a handful of batched calls from a
    `torch.Generator` keyed by (seed, chunk start step) (`draw_chunk`), so
    a resumed run draws what an uninterrupted one would;
  * its steps (`DiffStep`), each reading its draws from the chunk's
    buffers at a device-side step counter: gather the code rows,
    `q_sample`, the class and observation rows, eps-MSE, backward, Adam,
    then `ema = ema*d + p*(1-d)`. On the CPU the chunk loops this eager
    step; on a card it replays a CUDA graph of it, captured once (Adam
    with `capturable=True`, `_foreach_*` EMA updates, the losses summed
    into a device tensor). The eager step is the graph's plain version.
A chunk waits on the device once, when the caller reads its mean loss. A
failed capture raises: a card never falls back to the eager loop.

Learning rate: the reference trains at a constant `cfg.lr` whatever
`lr_schedule` says (its `init_diff_state` and `make_diff_scan` both build
`optax.adam(cfg.lr)`), and so does this trainer; `make_diff_tx` is the
schedule the config names, kept apart and not wired in.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from latent_diffusion_models_for_shape_sdfs_torch import losses
from latent_diffusion_models_for_shape_sdfs_torch.config import DiffConfig
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser import (
    CondDenoiser)
from latent_diffusion_models_for_shape_sdfs_torch.train.graph import (
    capture_step, deterministic_cudnn)
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger)

# std of the standard normal truncated to [-2, 2] (flax's lecun_normal
# divides by it so that the truncated draw has the variance asked for)
_TRUNC_STD = 0.87962566103423978


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


@dataclasses.dataclass
class DiffTrainState:
    model: CondDenoiser              # parameters trained in place
    ema: dict                        # parameter name -> its EMA tensor
    optimizer: torch.optim.Adam
    step: int                        # steps taken


def make_diff_tx(cfg: DiffConfig) -> Callable[[int], float]:
    """The learning rate at a step that `cfg.lr_schedule` names: constant
    `cfg.lr`, or "cosine" (optax.warmup_cosine_decay_schedule: linear
    warmup from 0, or from lr without warmup, to lr over warmup_steps,
    then cosine decay to 5% of lr at num_steps). Not used by this
    module's trainer, which keeps the reference's constant lr (module
    docstring); the encoder's trainer runs it (train.encoder.make_enc_tx),
    its update k (0-based) at the rate of step k, as optax's count does."""
    if cfg.lr_schedule == "constant":
        return lambda step: cfg.lr
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    init = 0.0 if cfg.warmup_steps else cfg.lr
    warm = max(cfg.warmup_steps, 1)
    decay = cfg.num_steps - warm
    if decay <= 0:
        raise ValueError("cosine schedule needs num_steps > warmup_steps")
    alpha = 0.05

    def lr(step: int) -> float:
        if step < warm:
            return init + (cfg.lr - init) * step / warm
        k = min(step - warm, decay)
        return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * k / decay))
                         + alpha)

    return lr


def flax_init_(model: nn.Module, generator: torch.Generator,
               zero: Optional[nn.Module] = None) -> None:
    """Re-draw every parameter from flax's default distributions (torch's
    differ): Dense and Conv kernels lecun-normal (truncated at 2 std, std
    sqrt(1/fan_in)/0.8796, fan_in = in_features, or kernel size x
    in_channels), zero biases; Embed normal with std 1/sqrt(features);
    LayerNorm and GroupNorm scale 1, bias 0. `zero` (default: the
    denoiser body's out_proj, or the UNet's head) starts at zero, as the
    reference's kernel_init=zeros."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(
                    m.embedding_dim), generator=generator)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        if zero is None:
            body = model.body
            zero = body.head if hasattr(body, "head") else body.out_proj
        nn.init.zeros_(zero.weight)
        nn.init.zeros_(zero.bias)


def init_diff_state(cfg: DiffConfig, model: Optional[CondDenoiser] = None,
                    seed: int = 0, device="cuda",
                    params: Optional[dict] = None) -> DiffTrainState:
    """Fresh state: flax's init drawn from a CPU `torch.Generator` seeded
    with `seed`, or the given `params` (a CondDenoiser state dict). The EMA
    starts as a distinct copy of the params; Adam(0.9, 0.999, 1e-8) at
    cfg.lr, capturable on a card (its step counts live on the device)."""
    dev = resolve_device(device)
    model = model or CondDenoiser(cfg.denoiser)
    if params is None:
        flax_init_(model, torch.Generator(device="cpu").manual_seed(int(seed)))
    else:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in params.items()})
    model.to(dev).train()
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 capturable=dev.type == "cuda")
    return DiffTrainState(model, ema, optimizer, 0)


def chunk_seed(*keys: int) -> int:
    """A generator seed derived from integer keys: (seed, start) for the
    chunk that starts at step `start`; other streams add a tag."""
    return int(np.random.SeedSequence([int(k) for k in keys])
               .generate_state(1, np.uint64)[0])


def draw_chunk(cfg: DiffConfig, num_codes: int, bank_n: int, start: int,
               device) -> dict:
    """One chunk's randomness, [scan_chunk, batch_size, ...] on `device`:
    code rows `idx` (with replacement), timesteps `t` in [0, T), noise
    `eps`; `drop` (Bernoulli(cond_drop_prob)) when classes or partial
    conditioning are on; observation columns `cols` when the bank holds
    more than partial_points points a scene."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chunk_seed(cfg.seed, start))
    C, B, c = cfg.scan_chunk, cfg.batch_size, cfg.denoiser
    out = {"idx": torch.randint(0, num_codes, (C, B), generator=gen,
                                device=dev),
           "t": torch.randint(0, cfg.timesteps, (C, B), generator=gen,
                              device=dev),
           "eps": torch.randn((C, B, c.latent_size), generator=gen,
                              device=dev)}
    if c.num_classes > 0 or c.partial_sdf_cond:
        out["drop"] = torch.rand((C, B), generator=gen,
                                 device=dev) < c.cond_drop_prob
    if c.partial_sdf_cond and bank_n > c.partial_points:
        out["cols"] = torch.randint(0, bank_n, (C, B, c.partial_points),
                                    generator=gen, device=dev)
    return out


class DiffStep:
    """The stage-2 step over a chunk's draws, eager or as a CUDA graph.

    The draws are copied into static buffers; step j reads row j of each
    at a device-side counter, so one captured step serves every step of
    every chunk. `codes_n` [N, L] are the normalized codes, `class_ids`
    [N] and `obs_xyz` [N, bank, 3] / `obs_sdf` [N, bank] the
    conditioning banks, all on the state's device."""

    def __init__(self, cfg: DiffConfig, state: DiffTrainState,
                 schedule: DiffusionSchedule, codes_n: torch.Tensor,
                 class_ids: torch.Tensor, obs_xyz: torch.Tensor,
                 obs_sdf: torch.Tensor):
        self.cfg, self.state, self.schedule = cfg, state, schedule
        self.codes_n, self.class_ids = codes_n, class_ids
        self.obs_xyz, self.obs_sdf = obs_xyz, obs_sdf
        dev = codes_n.device
        self.params = list(state.model.parameters())
        self.ema = [state.ema[k] for k, _ in state.model.named_parameters()]
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.bufs: Optional[dict] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _row(self, name: str) -> torch.Tensor:
        return self.bufs[name].index_select(0, self.counter)[0]

    def _step(self) -> None:
        c, st = self.cfg.denoiser, self.state
        idx, t, eps = self._row("idx"), self._row("t"), self._row("eps")
        z_t = self.schedule.q_sample(self.codes_n.index_select(0, idx), t,
                                     eps)
        kw = {}
        if c.num_classes > 0 or c.partial_sdf_cond:
            kw["cond_drop"] = self._row("drop")
        if c.num_classes > 0:
            kw["class_id"] = self.class_ids.index_select(0, idx)
        if c.partial_sdf_cond:
            ox = self.obs_xyz.index_select(0, idx)
            od = self.obs_sdf.index_select(0, idx)
            if "cols" in self.bufs:
                # a fresh observation subset per step (take_along_axis)
                cols = self._row("cols")
                ox = torch.gather(ox, 1, cols[..., None].expand(-1, -1, 3))
                od = torch.gather(od, 1, cols)
            kw["obs_xyz"], kw["obs_sdf"] = ox, od
        st.optimizer.zero_grad(set_to_none=True)
        with deterministic_cudnn():
            loss = losses.eps_mse(eps, st.model(z_t, t, **kw))
            loss.backward()
        st.optimizer.step()
        d = self.cfg.ema_decay
        with torch.no_grad():
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, torch._foreach_mul(self.params,
                                                             1.0 - d))
            self.loss_sum += loss.detach()
            self.counter += 1

    def _load(self, draws: dict) -> int:
        n = int(draws["idx"].shape[0])
        if self.bufs is None:
            self.bufs = {k: v.clone() for k, v in draws.items()}
        else:
            if n > self.bufs["idx"].shape[0] or set(draws) != set(self.bufs):
                raise ValueError("draws do not fit the step's buffers")
            for k, v in draws.items():
                self.bufs[k][:n].copy_(v)
        self.counter.zero_()
        self.loss_sum.zero_()
        return n

    def eager(self, draws: dict) -> torch.Tensor:
        """Run the chunk's steps one by one; returns the mean loss (a
        device scalar)."""
        n = self._load(draws)
        for _ in range(n):
            self._step()
        self.state.step += n
        return self.loss_sum / n

    def graphed(self, draws: dict) -> torch.Tensor:
        """The same steps by replaying the captured graph (captured on the
        first call); returns the mean loss (a device scalar)."""
        n = self._load(draws)
        if self.graph is None:
            self._capture()
        for _ in range(n):
            self.graph.replay()
        self.state.step += n
        return self.loss_sum / n

    def _capture(self) -> None:
        """Capture one step (train.graph.capture_step: a side-stream
        warm-up allocates the gradients and Adam's state, every tensor it
        changed is put back). Raises if the capture fails."""
        self.graph = capture_step(
            self._step, self.params + self.ema + [self.counter,
                                                   self.loss_sum],
            [self.state.optimizer])


def train_diffusion(cfg: DiffConfig, codes, class_ids=None, obs_xyz=None,
                    obs_sdf=None, logger: Optional[MetricLogger] = None,
                    state: Optional[DiffTrainState] = None,
                    checkpoint_fn: Optional[Callable] = None,
                    device="cuda") -> tuple:
    """Full stage-2 loop over the frozen latent table.

    `codes` is the RAW stage-1 table [N, L]; the normalization moments are
    computed here and returned (sampling needs them). `class_ids` [N],
    `obs_xyz` [N, bank, 3] / `obs_sdf` [N, bank]: conditioning banks. A
    `diff_chunk` record (step, loss, steps_per_sec of this call) is logged
    per chunk, and `checkpoint_fn(done, state, mu, sigma)` runs when
    `done % snapshot_every < scan_chunk`. Returns (model, state, (mu,
    sigma), last chunk's mean loss)."""
    dev = resolve_device(device)
    codes = torch.as_tensor(codes, dtype=torch.float32, device=dev)
    codes_n, mu, sigma = normalize_codes(codes)
    num_codes = int(codes.shape[0])
    schedule = DiffusionSchedule.create(cfg.timesteps, cfg.beta_start,
                                        cfg.beta_end, device=dev)
    if state is None:
        state = init_diff_state(cfg, seed=cfg.seed, device=dev)
    logger = logger or MetricLogger()
    if cfg.lr_schedule != "constant":
        logger.log("lr_schedule", asked=cfg.lr_schedule, used="constant",
                   lr=cfg.lr, note="the reference trains stage 2 at a "
                   "constant lr whatever lr_schedule says")

    def bank(a, shape, dtype):
        return (torch.zeros(shape, dtype=dtype, device=dev) if a is None
                else torch.as_tensor(a, dtype=dtype, device=dev))

    cids = bank(class_ids, (num_codes,), torch.long)
    oxyz = bank(obs_xyz, (num_codes, 1, 3), torch.float32)
    osdf = bank(obs_sdf, (num_codes, 1), torch.float32)
    step = DiffStep(cfg, state, schedule, codes_n, cids, oxyz, osdf)
    run = step.graphed if dev.type == "cuda" else step.eager

    last_loss = float("nan")
    start = state.step
    t0 = time.perf_counter()
    while state.step < cfg.num_steps:
        draws = draw_chunk(cfg, num_codes, oxyz.shape[1], state.step, dev)
        last_loss = float(run(draws))          # the chunk's one wait
        done = state.step
        dt = time.perf_counter() - t0
        logger.log("diff_chunk", step=done, loss=last_loss,
                   steps_per_sec=(done - start) / max(dt, 1e-9))
        if checkpoint_fn and cfg.snapshot_every and (
                done % cfg.snapshot_every < cfg.scan_chunk):
            checkpoint_fn(done, state, mu, sigma)
    return state.model, state, (mu, sigma), last_loss
