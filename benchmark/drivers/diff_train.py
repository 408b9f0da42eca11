"""Stage-2 training: the port's graphed stage-2 step
(`train.diffusion.DiffStep.graphed`), one chunk of `scan_chunk` steps
after another.

Set-up normalizes the pack's codes, builds the observation bank (the
port's CSG bank of the pack's 13-class split, a balanced draw of
`obs_bank_points` rows a scene), makes the denoiser's weights from the
seed, and builds one DiffStep. Its first three steps go through the
window's own call, one step a call, and are recorded for the reference;
the same step object then serves the window's chunks, each ended by the
read of its mean loss.
"""

from __future__ import annotations

import json
import math
import pathlib
import time

import torch

from benchmark.checks import Laps, leaf_gap_table, rel_gap
from benchmark.reference import decoder as dec_ref
from benchmark.reference import denoiser as ref
from benchmark.yardstick import denoiser_step_flops

ROOT = pathlib.Path(__file__).resolve().parents[2]
FIRST = 3


def make_weights(model, gen: torch.Generator, device) -> dict:
    """Every leaf of the denoiser from `gen` in one call: dense and
    embedding weights N(0, 1/fan_in), biases and layer-norm shifts
    N(0, 0.02^2), layer-norm scales 1 + N(0, 0.1^2). A network some way
    into training, not flax's init (whose zero output layer would leave
    every other gradient zero at the first step)."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        x = flat[at:at + n].view(s)
        at += n
        if k.endswith(".weight") and len(s) == 2:
            x = x / math.sqrt(s[1])
        elif ".ln." in k or "_ln." in k:
            x = 1.0 + 0.1 * x if k.endswith(".weight") else 0.02 * x
        else:
            x = 0.02 * x
        out[k] = x
    return out


class Driver:

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 seconds: float):
        from latent_diffusion_models_for_shape_sdfs_torch.config import (
            ExperimentConfig)
        from latent_diffusion_models_for_shape_sdfs_torch.data import (
            analytic, analytic_device)
        from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule \
            import DiffusionSchedule
        from latent_diffusion_models_for_shape_sdfs_torch.models.denoiser \
            import CondDenoiser
        from latent_diffusion_models_for_shape_sdfs_torch.train import (
            diffusion as td)
        self.cfg, self.traffic, self.dev = cfg, traffic, device
        self.td = td
        diff = dict(cfg["diff"], seed=seed)
        self.diff = diff
        self.dc = dc = ExperimentConfig.from_json(json.dumps(
            {"diff": diff})).diff
        self.phases = lap = Laps(device)
        _, codes = dec_ref.load_pack(ROOT / cfg["pack"], device)
        n = codes.shape[0]
        self.codes_n, _, _ = td.normalize_codes(codes)
        k = cfg["num_classes"]
        self.class_ids = torch.arange(n, device=device) % k
        lap("pack")
        shapes = analytic.make_synthetic_split("classes13", n,
                                               seed=cfg["split_seed"])
        bank_n = diff["denoiser"]["obs_bank_points"] or \
            4 * diff["denoiser"]["partial_points"]
        bank = analytic_device.bank_from_csg(shapes, seed, bank_n,
                                             device=device)
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        self.obs_xyz, self.obs_sdf = bank.sample_batch(
            g, torch.arange(n, device=device), bank_n)
        del bank
        lap("observations")
        self.sched = DiffusionSchedule.create(
            diff["timesteps"], diff["beta_start"], diff["beta_end"],
            device=device)
        model = CondDenoiser(self.dc.denoiser)
        self.params0 = make_weights(model, g, device)
        self.state = td.init_diff_state(self.dc, model, device=device,
                                        params=self.params0)
        self.step = td.DiffStep(self.dc, self.state, self.sched,
                                self.codes_n, self.class_ids, self.obs_xyz,
                                self.obs_sdf)
        self.chunk = self.dc.scan_chunk
        self.bank_n = bank_n
        self.start = 0
        draws = self._draws()
        self.first = [{k: v[i] for k, v in draws.items()}
                      for i in range(FIRST)]
        run = self.step.graphed if device.type == "cuda" else self.step.eager
        self.run_chunk = run
        # size the step's buffers for whole chunks, then the first steps
        # one call each
        self.step.bufs = {k: v.clone() for k, v in draws.items()}
        lap("state")
        self.losses = []
        for i in range(FIRST):
            one = {k: v[i:i + 1] for k, v in draws.items()}
            self.losses.append(run(one))
            if i == 0:
                opt = self.state.optimizer
                self.exp_avg1 = {
                    k: opt.state[p]["exp_avg"].clone()
                    if "exp_avg" in opt.state[p] else torch.zeros_like(p)
                    for k, p in self.state.model.named_parameters()}
        self.after = {k: p.detach().clone() for k, p in
                      self.state.model.named_parameters()}
        self.ema_after = {k: v.clone() for k, v in self.state.ema.items()}
        lap("first_steps")
        for _ in range(traffic["warmup_chunks"]):
            float(run(self._draws()))
        lap("warmup")
        self.step_flops = denoiser_step_flops(diff["denoiser"],
                                              diff["batch_size"])
        self.steps = FIRST
        self.chunks_ok = 0
        self.chunks = 0

    def _draws(self) -> dict:
        d = self.td.draw_chunk(self.dc, self.codes_n.shape[0], self.bank_n,
                               self.start, self.dev)
        self.start += self.chunk
        return d

    def _chunk(self) -> None:
        loss = float(self.run_chunk(self._draws()))
        self.chunks += 1
        self.chunks_ok += int(math.isfinite(loss))
        self.steps += self.chunk

    def run(self, seconds: float) -> dict:
        """Whole chunks until `seconds` have passed, each ended by its
        loss's read: the window over the steps completed."""
        t0 = time.perf_counter()
        n = 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            self._chunk()
            n += self.chunk
        window = time.perf_counter() - t0
        return {"diff_step_ms": 1e3 * window / n}

    def traced(self) -> tuple:
        k = int(self.traffic["trace_chunks"])
        self.trace_work = dict(steps=k * self.chunk)
        return self._chunk, (lambda: [self._chunk() for _ in range(k)])

    # ------------------------------------------------------------ check
    def free(self) -> None:
        self.losses = [float(v) for v in self.losses]
        del self.state, self.step, self.run_chunk
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def counts(self) -> tuple:
        bad = sum(1 for v in self.losses if not math.isfinite(v))
        return self.steps, bad + (self.chunks - self.chunks_ok) * self.chunk

    def readings(self, tf32: bool = False, against: dict | None = None
                 ) -> tuple:
        res = ref.train_steps(self.params0, self.diff, self.codes_n,
                              self.class_ids, self.obs_xyz, self.obs_sdf,
                              self.first, tf32=tf32)
        if against is None:
            got = dict(losses=self.losses,
                       grad1={k: v / 0.1 for k, v in self.exp_avg1.items()},
                       leaves=self.after, ema=self.ema_after)
            base = res
        else:
            got, base = res, against
        start = self.params0
        g_ref = base["grad1"]
        grad = leaf_gap_table(got["grad1"], g_ref)
        change = leaf_gap_table(
            {k: got["leaves"][k] - start[k] for k in g_ref},
            {k: base["leaves"][k] - start[k] for k in g_ref}, moving=g_ref)
        ema = leaf_gap_table(
            {k: got["ema"][k] - start[k] for k in g_ref},
            {k: base["ema"][k] - start[k] for k in g_ref}, moving=g_ref)
        self.detail = {"losses": [float(v) for v in got["losses"]],
                       "ref_losses": base["losses"], "grad": grad,
                       "change": change, "ema": ema}
        return {"loss_gap": max(rel_gap(a, b) for a, b in
                                zip(got["losses"], base["losses"])),
                "grad_gap": max(grad.values()),
                "change_gap": max(change.values()),
                "ema_gap": max(ema.values())}, res

    def check(self) -> dict:
        readings, self.ref = self.readings()
        return readings

    def control(self) -> dict:
        """The control: the reference with TF32 products (the precision
        below the configuration's float32 with TF32 off)."""
        return self.readings(tf32=True, against=self.ref)[0]
