"""Stage-1 training from the on-device sample bank: the port's bank step
(`train.auto_decoder.make_bank_step`) back to back.

Set-up makes the chairs and the weights from the seed, has the port build
its bank on the card, and builds one training state. The state's first
three steps run through the window's own call and feed (scene ids from
one seeded permutation, so their rows all differ) and are recorded for
the reference; the same state then trains through the window.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from benchmark import frozen
from benchmark.checks import Laps, leaf_gap_table, norm, rel_gap, sync
from benchmark.reference import decoder as ref
from benchmark.yardstick import decoder_layers, train_step_flops

FIRST = 3          # steps the reference follows
CANCEL = 0.05      # a leaf's gap is over at least this share of the
#                    magnitudes of its gradient's terms (readings())
# how each route rounds the activations it keeps in bf16, by use_pallas:
# kernel #3 rounds the layer's output, then its dropout-scaled value;
# kernel #4 rounds relu times the scale once
STORE = {False: "double", True: "single"}


def ad_config(cfg: dict, traffic: dict):
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    ad = dict(cfg["ad"], use_pallas=traffic["use_pallas"], device_data=True)
    return ExperimentConfig.from_json(json.dumps({"ad": ad})).ad


def make_weights(ad: dict, gen: torch.Generator, device) -> tuple:
    """The decoder's leaves (torch layout v [out, in], g, b) and the code
    table from `gen`, in two calls: DeepSDF's init, v and b uniform in
    +-1/sqrt(in) with g = ||v[o, :]||, codes N(0, std^2 / L)."""
    dec = ad["decoder"]
    plan = decoder_layers(dec)
    sizes = [(o * i, o) for i, o, _ in plan]
    flat = torch.rand(sum(a + b for a, b in sizes), generator=gen,
                      device=device) * 2.0 - 1.0
    params, at = {}, 0
    for layer, ((i, o, _), (nv, nb)) in enumerate(zip(plan, sizes)):
        k = 1.0 / math.sqrt(i)
        v = flat[at:at + nv].view(o, i) * k
        b = flat[at + nv:at + nv + nb] * k
        at += nv + nb
        params[f"lin{layer}.v"] = v
        params[f"lin{layer}.b"] = b
        if dec["weight_norm"]:
            params[f"lin{layer}.g"] = torch.sqrt(torch.sum(v * v, dim=1))
    L = dec["latent_size"]
    codes = torch.randn((ad["num_scenes"], L), generator=gen,
                        device=device) * (ad["code_init_std"] / math.sqrt(L))
    return params, codes


class Driver:

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 seconds: float):
        from latent_diffusion_models_for_shape_sdfs_torch.data import (
            analytic_device)
        from latent_diffusion_models_for_shape_sdfs_torch.models.decoder \
            import SdfDecoder
        from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder \
            import init_ad_state, make_bank_step
        self.cfg, self.traffic, self.dev = cfg, traffic, device
        self.ad = ad = cfg["ad"]
        self.adc = adc = ad_config(cfg, traffic)
        S, P, N = ad["scenes_per_batch"], ad["samples_per_scene"], \
            ad["num_scenes"]
        self.phases = lap = Laps(device)
        trees, self.chairs = frozen.make_chairs(N, seed)
        lap("chairs")
        self.bank = analytic_device.bank_from_chairs(trees, seed, P,
                                                     device=device)
        lap("bank")
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params, codes = make_weights(ad, gen, device)
        self.params0 = params
        self.codes0 = codes
        self.state = init_ad_state(adc, SdfDecoder(adc.decoder),
                                   params=params,
                                   codes=codes, device=device)
        self.draw = torch.Generator(device=device)
        self.draw.manual_seed(seed + 1)
        self.draw0 = self.draw.get_state()
        self.step = make_bank_step(self.state.decoder, adc, self.bank,
                                   self.draw)
        lap("state")
        # scene ids: one seeded permutation of the bank an epoch, enough
        # epochs for the longest window at 10 ms a step
        rng = np.random.default_rng([seed, 1])
        n_steps = FIRST + int(seconds / 0.010) + 64
        per_epoch = N // S
        epochs = -(-n_steps // per_epoch)
        ids = np.concatenate([rng.permutation(N)[:per_epoch * S]
                              for _ in range(epochs)]).reshape(-1, S)
        self.ids = torch.from_numpy(ids.astype(np.int64)).to(device)
        self.seeds = [int(s) for s in
                      rng.integers(0, 2 ** 31 - 1, len(ids))]
        self.epoch = float(traffic["epoch"])
        self.next = 0
        # the first steps, recorded for the reference
        self.losses = []
        for i in range(FIRST):
            m = self._one()
            self.losses.append(m["loss"])
            if i == 0:
                opt = self.state.optimizer
                self.exp_avg1 = {
                    k: opt.state[p]["exp_avg"].clone()
                    if "exp_avg" in opt.state[p] else torch.zeros_like(p)
                    for k, p in self._leaves().items()}
        self.after = {k: p.detach().clone()
                      for k, p in self._leaves().items()}
        lap("first_steps")
        for _ in range(traffic["warmup_steps"]):
            self._one()
        lap("warmup")
        self.step_flops = train_step_flops(ad["decoder"], S, P)

    def _leaves(self) -> dict:
        out = dict(self.state.decoder.named_parameters())
        out["codes"] = self.state.codes
        return out

    def _one(self):
        i = self.next
        self.next += 1
        return self.step(self.state, self.ids[i], self.epoch, self.seeds[i])

    def run(self, seconds: float) -> dict:
        """Steps back to back until `seconds` have passed on the host
        clock, then a synchronize: the window is the whole time over the
        steps it completed."""
        t0 = time.perf_counter()
        n = 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            if self.next >= len(self.ids):
                raise RuntimeError("the window outran its scene ids")
            self._one()
            n += 1
        sync(self.dev)
        window = time.perf_counter() - t0
        return {"ad_step_ms": 1e3 * window / n}

    def traced(self) -> tuple:
        """(warm-up, measured) callables for the traced run."""
        k = int(self.traffic["trace_steps"])

        def steps():
            for _ in range(k):
                self._one()
        self.trace_work = dict(steps=k)
        return (lambda: [self._one() for _ in range(2)]), steps

    # ------------------------------------------------------------ check
    def free(self) -> None:
        """Drop the program's state; keep what the reference reads."""
        self.losses = [float(v) for v in self.losses]
        del self.state, self.step
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def counts(self) -> tuple:
        """(steps attempted, steps whose recorded loss is not finite)."""
        bad = sum(1 for v in self.losses if not math.isfinite(v))
        return self.next, bad

    def check(self) -> dict:
        """The program's numbers against the reference."""
        readings, self.ref = self.readings()
        return readings

    def control(self) -> dict:
        """The control's numbers: the reference with fp8 products, against
        the reference (after check())."""
        return self.readings("fp8", against=self.ref)[0]

    def batches(self) -> tuple:
        """The first steps' batches, drawn again from the recorded
        generator state as the bank's contract says (per step: uniforms
        for the positive half, then the negative half; row
        int(u * count)), each row's label held against the frozen SDF.
        Returns (batches, label gap, sign errors)."""
        S, P = self.ad["scenes_per_batch"], self.ad["samples_per_scene"]
        gen = torch.Generator(device=self.dev)
        gen.set_state(self.draw0)
        half = P // 2
        out, gap, bad = [], 0.0, 0
        for i in range(FIRST):
            ids = self.ids[i]
            u1 = torch.rand((S, half), generator=gen, device=self.dev)
            u2 = torch.rand((S, P - half), generator=gen, device=self.dev)
            i1 = (u1 * self.bank.pos_count[ids][:, None]).long()
            i2 = (u2 * self.bank.neg_count[ids][:, None]).long()
            sid = ids[:, None]
            rows = torch.cat([self.bank.pos[sid, i1], self.bank.neg[sid, i2]],
                             dim=1).float()
            xyz, sdf = rows[..., :3], rows[..., 3]
            truth = frozen.chair_sdf(self.chairs.take(ids.cpu()), xyz).float()
            gap = max(gap, float((truth - sdf).abs().max()))
            both = (self.bank.pos_count[ids] + self.bank.neg_count[ids]
                    == P)[:, None]
            bad += int((both & (sdf[:, :half] < 0)).sum()
                       + (both & (sdf[:, half:] >= 0)).sum())
            out.append((ids, xyz, sdf, self.seeds[i]))
        return out, gap, bad

    def readings(self, product: str = "bf16", against: dict | None = None
                 ) -> tuple:
        """The numbers compared, the program's against the reference, or
        (`product` lowered, `against` the reference's result) the
        control's; and the reference's result. The reference computes in
        the configuration's bf16, keeping what the route keeps in bf16
        where the route keeps it (STORE; reference/decoder.py).

        `grad_leaf_gap`: the worst leaf's distance of the first gradient
        from the reference's, over the larger of the reference gradient's
        norm and CANCEL times the norm of its terms' magnitudes. At the
        DeepSDF init the signs of pred - sdf over a step's balanced
        positive and negative samples nearly cancel on some seeds, and
        every leaf's gradient with them: the points whose sign a rounding
        flips then move a leaf's sum by far more than its size, and the
        second scale bounds that at 2 x (flipped share) / CANCEL. Against
        an fp32 reference bf16's own flips read as much on such seeds as
        fp8's do on others; against the same bf16 rounding points only
        the summation order differs. A gap of norms does not separate
        fp8 products from bf16 at all: it sees a gradient's length, and
        rounding moves its direction.

        `change_leaf_gap`: the worst leaf's gap of norms of the change over
        the three steps (leaves whose reference gradient is under a
        thousandth of the median leaf's moved by round-off alone and are
        left out; none is in this decoder). `codes_moved` counts the code
        rows that moved in one and not the other: every scene of every
        step moves its row. `loss1_gap` is the first step's loss against
        the reference's; the later two are kept in `detail`, not
        compared: Adam's first step moves each weight by the sign of its
        gradient, so the elements whose gradient is near nought move
        either way, and the later losses of sound runs read up to a
        third of the control's."""
        batches, label_gap, bad = self.batches()
        res = ref.train_steps(self.params0, self.codes0, self.ad, batches,
                              self.epoch, product=product,
                              store=STORE[self.traffic["use_pallas"]],
                              terms=against is None)
        if against is None:
            got_loss = self.losses
            got_g1 = {k: v / 0.1 for k, v in self.exp_avg1.items()}
            got_after = self.after
            base = res
        else:
            got_loss = res["losses"]
            got_g1 = res["grad1"]
            got_after = res["leaves"]
            base = against
        start = dict(self.params0, codes=self.codes0)
        g_ref = base["grad1"]
        grad = {k: norm(got_g1[k].float() - g_ref[k]) / max(
            norm(g_ref[k]), CANCEL * norm(base["terms1"][k]), 1e-30)
            for k in sorted(g_ref)}
        change = leaf_gap_table(
            {k: got_after[k] - start[k] for k in g_ref},
            {k: base["leaves"][k] - start[k] for k in g_ref}, moving=g_ref)
        loss_gaps = [rel_gap(a, b) for a, b in zip(got_loss, base["losses"])]
        self.detail = {
            "losses": [float(v) for v in got_loss],
            "ref_losses": base["losses"], "loss_gaps": loss_gaps,
            "grad": grad, "change": change,
            "cancel": {k: norm(g_ref[k]) / max(norm(base["terms1"][k]),
                                                 1e-30) for k in g_ref}}
        moved = [int((t - self.codes0 != 0).any(dim=1).sum()) for t in
                 (got_after["codes"], base["leaves"]["codes"])]
        return {"loss1_gap": loss_gaps[0],
                "grad_leaf_gap": max(grad.values()),
                "change_leaf_gap": max(change.values()),
                "codes_moved": abs(moved[0] - moved[1]),
                "label_gap": label_gap,
                "sign_errors": bad}, res
