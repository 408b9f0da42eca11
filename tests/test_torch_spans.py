"""The spans inside the port's training steps (`utils.profiling.span`):
under `profiling.trace` on the CPU the stage-1 bank step shows its phases
once a step and in order on both routes, an eager stage-2 chunk shows one
`diff.steps`, and the losses and parameters are the same bits with the
spans on and off. Imports neither JAX nor the JAX package; the one card
test (marker `gpu`, skipped without a card) runs on the card with

    python -m pytest tests/test_torch_spans.py -m gpu --noconftest
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from latent_diffusion_models_for_shape_sdfs_torch import config as tcfg
from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank import (
    DeviceSampleBank)
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.train import (
    auto_decoder as tad)
from latent_diffusion_models_for_shape_sdfs_torch.train import (
    diffusion as ttd)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

torch.set_num_threads(2)

STEP_SPANS = ("ad.draw", "ad.forward", "ad.backward", "ad.update")
# each route's phases a step, in order: the fused route is one pass
# between the draw and the update
ROUTES = {"autograd": (dict(samples_per_scene=256), STEP_SPANS),
          "fused": (dict(samples_per_scene=512, use_pallas=True),
                    ("ad.draw", "ad.update"))}


def _bank_run(route: str, steps: int = 3):
    """A fresh bank-step state on the CPU: (state, step(i) -> metrics)."""
    extra, _ = ROUTES[route]
    cfg = tcfg.AdConfig(
        decoder=tcfg.DecoderConfig(latent_size=16, hidden_dim=64,
                                   num_layers=3, latent_in=(2,)),
        num_scenes=4, scenes_per_batch=2, clamp_dist=0.2, device_data=True,
        **extra)
    rng = np.random.default_rng(0)
    rows = [np.concatenate([rng.uniform(-1, 1, (600, 3)),
                            0.15 * rng.normal(size=(600, 1))], 1)
            .astype(np.float32) for _ in range(4)]
    bank = DeviceSampleBank.from_dataset(
        SdfDataset([r[r[:, 3] >= 0] for r in rows],
                   [r[r[:, 3] < 0] for r in rows]), device="cpu")
    state = tad.init_ad_state(cfg, seed=0, device="cpu")
    step = tad.make_bank_step(state.decoder, cfg, bank,
                              torch.Generator().manual_seed(1))
    ids = [torch.from_numpy(rng.permutation(4)[:2]) for _ in range(steps)]
    return state, lambda i: step(state, ids[i], 150.0, i)


def _traced_names(logdir, names) -> list:
    """The host ranges among `names` in the Chrome trace under `logdir`,
    by start time."""
    path, = pathlib.Path(logdir).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("ph") == "X" and e.get("name") in names]


@pytest.mark.parametrize("route", list(ROUTES))
def test_bank_steps_show_their_phases_in_order(tmp_path, route):
    _, want = ROUTES[route]
    _, step = _bank_run(route)
    with profiling.trace(tmp_path, device="cpu"):
        for i in range(3):
            step(i)
    assert _traced_names(tmp_path, set(STEP_SPANS)) == list(want) * 3
    for name in want:
        recs = profiling.span_records(name, last=3)
        assert len(recs) == 3
        assert all(host > 0 and dev is None for host, dev in recs), recs


def _diff_step():
    den = tcfg.DenoiserConfig(latent_size=16, hidden_dim=64, num_blocks=2,
                              time_embed_dim=32, num_classes=5,
                              partial_sdf_cond=True, partial_points=24,
                              cond_drop_prob=0.3)
    cfg = tcfg.DiffConfig(denoiser=den, timesteps=100, batch_size=8,
                          lr=1e-3, ema_decay=0.9, scan_chunk=3)
    rng = np.random.default_rng(0)
    n, bank = 10, 64
    state = ttd.init_diff_state(cfg, seed=0, device="cpu")
    step = ttd.DiffStep(
        cfg, state, DiffusionSchedule.create(cfg.timesteps, cfg.beta_start,
                                             cfg.beta_end, device="cpu"),
        torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 5, n)),
        torch.from_numpy(rng.uniform(-1, 1, (n, bank, 3))
                         .astype(np.float32)),
        torch.from_numpy((0.1 * rng.normal(size=(n, bank)))
                         .astype(np.float32)))
    return cfg, state, step, (n, bank)


def test_eager_chunk_shows_one_span(tmp_path):
    cfg, _, step, (n, bank) = _diff_step()
    with profiling.trace(tmp_path, device="cpu"):
        for start in (0, cfg.scan_chunk):
            step.eager(ttd.draw_chunk(cfg, n, bank, start, "cpu"))
    assert _traced_names(tmp_path, {"diff.steps"}) == ["diff.steps"] * 2
    assert [d for _, d in profiling.span_records("diff.steps", last=2)] \
        == [None, None]


def _leaves(module, *extra) -> list:
    return [t.detach().clone() for t in (*module.parameters(), *extra)]


@pytest.mark.parametrize("route", list(ROUTES) + ["diffusion"])
def test_spans_on_and_off_give_the_same_bits(tmp_path, route):
    runs = []
    for on in (False, True):
        if route == "diffusion":
            cfg, state, step, (n, bank) = _diff_step()

            def run():
                return [float(step.eager(ttd.draw_chunk(cfg, n, bank, 0,
                                                        "cpu")))]
        else:
            state, step = _bank_run(route)

            def run():
                return [float(step(i)["loss"]) for i in range(3)]
        if on:
            with profiling.trace(tmp_path, device="cpu"):
                losses = run()
        else:
            losses = run()
        extra = (state.codes,) if route != "diffusion" else \
            tuple(state.ema.values())
        model = state.decoder if route != "diffusion" else state.model
        runs.append((losses, _leaves(model, *extra)))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert len(p0) == len(p1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_capture_under_a_profiler_records_no_events():
    """A span entered while the stream captures a CUDA graph keeps its
    host range and records no event; the same span on the stream outside
    the capture has a device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.cuda.graph(graph):
            with profiling.span("test.captured"):
                y = x * 2
        graph.replay()
        with profiling.span("test.eager"):
            y = y * 2
    torch.cuda.synchronize()
    (host, dev), = profiling.span_records("test.captured", last=1)
    assert host > 0 and dev is None
    (host, dev), = profiling.span_records("test.eager", last=1)
    assert host > 0 and dev is not None and dev >= 0
    assert float(y[0]) == 4.0
