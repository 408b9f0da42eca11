"""Amortized-encoder training: regress the frozen stage-1 latent table.

Counterpart of the JAX package's `train/encoder.py`: a PointNet-style set
encoder (models/encoder.py) learns to predict scene i's normalized code
from a random subset of scene i's observation bank. The reference runs
`scan_chunk` steps as one `lax.scan`. Here a chunk is:
  * its randomness, drawn up front from a `torch.Generator` keyed by
    (seed, chunk start step) (`draw_chunk`): scene ids `ids [C, B]` in
    [0, S) and observation rows `pidx [C, B, n_obs]` in [0, P);
  * its steps (`EncStep`), each reading its draws and its learning rate at
    a device-side step counter: gather `bank[ids]` and then the `pidx`
    rows, MSE to `codes_n[ids]`, backward, Adam. On the CPU the chunk
    loops this eager step; on a card it replays one CUDA graph of it
    (train.graph.capture_step), with one host wait a chunk; a failed
    capture raises.

The learning rate is the schedule the config names (`make_enc_tx`:
optax's warmup_cosine_decay_schedule for "cosine", as the reference wires
it), read by the step from a table of the chunk's rates: Adam's lr is a
tensor the step fills, so the graph sees each step's rate.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from latent_diffusion_models_for_shape_sdfs_torch.config import EncConfig
from latent_diffusion_models_for_shape_sdfs_torch.models.encoder import (
    LatentEncoder)
from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
    chunk_seed, flax_init_, make_diff_tx, normalize_codes)
from latent_diffusion_models_for_shape_sdfs_torch.train.graph import (
    capture_step)
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger)


@dataclasses.dataclass
class EncTrainState:
    model: LatentEncoder             # parameters trained in place
    optimizer: torch.optim.Adam      # its lr is a tensor the step fills
    step: int                        # steps taken


# the learning rate at a step, the reference's `make_enc_tx` schedule:
# stage 2's (constant, or optax's warmup-cosine), which reads the same
# lr / lr_schedule / warmup_steps / num_steps fields
make_enc_tx = make_diff_tx


def init_enc_state(cfg: EncConfig, model: Optional[LatentEncoder] = None,
                   seed: int = 0, device="cuda") -> EncTrainState:
    """Fresh state: flax's init drawn from a CPU `torch.Generator` seeded
    with `seed` (`out` zero), Adam(0.9, 0.999, 1e-8) with a tensor lr on
    the device, capturable on a card."""
    dev = resolve_device(device)
    model = model or LatentEncoder(cfg.encoder)
    flax_init_(model, torch.Generator(device="cpu").manual_seed(int(seed)),
               zero=model.out)
    model.to(dev).train()
    lr = torch.tensor(float(make_enc_tx(cfg)(0)), dtype=torch.float32,
                      device=dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 capturable=dev.type == "cuda")
    return EncTrainState(model, optimizer, 0)


def draw_chunk(cfg: EncConfig, num_scenes: int, bank_n: int, start: int,
               device) -> dict:
    """One chunk's randomness on `device`: scene ids `ids [C, B]` in [0,
    num_scenes) and observation rows `pidx [C, B, n_obs]` in [0, bank_n),
    C = scan_chunk, B = batch_scenes, from a generator keyed by (seed,
    start)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chunk_seed(cfg.seed, start))
    C, B = cfg.scan_chunk, cfg.batch_scenes
    return {"ids": torch.randint(0, num_scenes, (C, B), generator=gen,
                                 device=dev),
            "pidx": torch.randint(0, bank_n, (C, B, cfg.n_obs),
                                  generator=gen, device=dev)}


class EncStep:
    """The encoder step over a chunk's draws, eager or as a CUDA graph.

    `bank` [S, P, 4] holds each scene's observation rows (xyz, sdf),
    `codes_n` [S, L] the normalized codes, on the state's device. The
    draws and the chunk's learning rates are copied into static buffers;
    step j reads row j of each at a device-side counter."""

    def __init__(self, cfg: EncConfig, state: EncTrainState,
                 bank: torch.Tensor, codes_n: torch.Tensor):
        self.cfg, self.state = cfg, state
        self.bank, self.codes_n = bank, codes_n
        dev = codes_n.device
        self.params = list(state.model.parameters())
        self.lr = state.optimizer.param_groups[0]["lr"]
        # every step's rate, made once (a chunk copies its rows on the card)
        lr = make_enc_tx(cfg)
        self.lr_table = torch.tensor(
            [lr(j) for j in range(cfg.num_steps + cfg.scan_chunk)],
            dtype=torch.float32).to(dev)
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)
        self.last = torch.zeros((), dtype=torch.float32, device=dev)
        self.bufs: Optional[dict] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _row(self, name: str) -> torch.Tensor:
        return self.bufs[name].index_select(0, self.counter)[0]

    def _step(self) -> None:
        st = self.state
        ids, pidx = self._row("ids"), self._row("pidx")
        pts = self.bank[ids[:, None], pidx]                 # [B, n, 4]
        self.lr.copy_(self._row("lr"))
        st.optimizer.zero_grad(set_to_none=True)
        z_hat = st.model(pts[..., :3], pts[..., 3])
        d = z_hat - self.codes_n.index_select(0, ids)
        loss = torch.mean(d * d)
        loss.backward()
        st.optimizer.step()
        with torch.no_grad():
            self.last.copy_(loss.detach())
            self.counter += 1

    def _load(self, draws: dict) -> int:
        n = int(draws["ids"].shape[0])
        start = self.state.step
        if start + n > len(self.lr_table):
            raise ValueError("the chunk runs past the step's rate table")
        draws = dict(draws, lr=self.lr_table[start:start + n])
        if self.bufs is None:
            self.bufs = {k: v.clone() for k, v in draws.items()}
        else:
            if n > self.bufs["ids"].shape[0] or set(draws) != set(self.bufs):
                raise ValueError("draws do not fit the step's buffers")
            for k, v in draws.items():
                self.bufs[k][:n].copy_(v)
        self.counter.zero_()
        return n

    def eager(self, draws: dict) -> torch.Tensor:
        """Run the chunk's steps one by one; returns the last step's loss
        (a device scalar)."""
        n = self._load(draws)
        for _ in range(n):
            self._step()
        self.state.step += n
        return self.last

    def graphed(self, draws: dict) -> torch.Tensor:
        """The same steps by replaying the captured graph (captured on the
        first call); returns the last step's loss (a device scalar)."""
        n = self._load(draws)
        if self.graph is None:
            self.graph = capture_step(
                self._step, self.params + [self.lr, self.counter,
                                           self.last],
                [self.state.optimizer])
        for _ in range(n):
            self.graph.replay()
        self.state.step += n
        return self.last


def make_bank(obs_xyz, obs_sdf, device) -> torch.Tensor:
    """Observation bank [S, P, 4] (xyz, sdf) on `device` from [S, P, 3] /
    [S, P] arrays or tensors."""
    return torch.cat([torch.as_tensor(obs_xyz, dtype=torch.float32,
                                      device=device),
                      torch.as_tensor(obs_sdf, dtype=torch.float32,
                                      device=device)[..., None]], dim=-1)


def train_encoder(cfg: EncConfig, codes, obs_xyz, obs_sdf,
                  logger: Optional[MetricLogger] = None,
                  state: Optional[EncTrainState] = None,
                  checkpoint_fn: Optional[Callable] = None,
                  device="cuda") -> tuple:
    """Train the encoder against a frozen latent table.

    codes [S, L]: the stage-1 table (frozen targets; normalized here, the
    moments returned). obs_xyz [S, P, 3] / obs_sdf [S, P]: each scene's
    observation bank; every step subsamples cfg.n_obs of the P rows per
    drawn scene. An `enc_train` record (step, last loss, steps_per_sec of
    this call) is logged per chunk, and `checkpoint_fn(done, state, mu,
    sigma)` runs when a multiple of snapshot_every is crossed or the last
    step is done. Returns (model, state, (mu, sigma), final loss)."""
    dev = resolve_device(device)
    if state is None:
        state = init_enc_state(cfg, seed=cfg.seed, device=dev)
    codes = torch.as_tensor(codes, dtype=torch.float32, device=dev)
    codes_n, mu, sigma = normalize_codes(codes)
    bank = make_bank(obs_xyz, obs_sdf, dev)
    S, P = bank.shape[0], bank.shape[1]
    step = EncStep(cfg, state, bank, codes_n)
    run = step.graphed if dev.type == "cuda" else step.eager
    logger = logger or MetricLogger()

    start = state.step
    t0 = time.perf_counter()
    loss = float("nan")
    while state.step < cfg.num_steps:
        draws = draw_chunk(cfg, S, P, state.step, dev)
        chunk = min(cfg.scan_chunk, cfg.num_steps - state.step)
        draws = {k: v[:chunk] for k, v in draws.items()}
        loss = float(run(draws))                 # the chunk's one wait
        done = state.step
        logger.log("enc_train", step=done, loss=loss,
                   steps_per_sec=(done - start) / max(
                       time.perf_counter() - t0, 1e-9))
        if checkpoint_fn is not None and (
                done // cfg.snapshot_every > (done - chunk)
                // cfg.snapshot_every or done >= cfg.num_steps):
            checkpoint_fn(done, state, mu, sigma)
    return state.model, state, (mu, sigma), loss
