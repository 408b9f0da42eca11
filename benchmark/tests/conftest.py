"""Tiny cells for the benchmark's CPU tests: the manifest's cells, and the
parked ones whose files the harness keeps, with their configurations cut
to a few scenes and narrow layers and the packs to a few codes."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

RUN_LOAD_CELL = run.load_cell      # before any test patches it


def shrink(cell: str, cfg: dict, traffic: dict) -> None:
    """Cut a cell to a CPU test's size, in place."""
    if "ad" in cfg:
        cfg["ad"].update(num_scenes=16, scenes_per_batch=4,
                         samples_per_scene=256)
        cfg["ad"]["decoder"].update(latent_size=16, hidden_dim=32,
                                    num_layers=4, latent_in=[2])
    if traffic["driver"] == "serve":
        cfg["ad"]["decoder"].update(latent_size=256, hidden_dim=512,
                                    num_layers=8, latent_in=[4])
        traffic.update(batch=2, res=32, warmup_latents=1, check_meshes=2,
                       check_points=256, surface_res=16)
    if traffic["driver"] == "diff_train":
        cfg["diff"].update(batch_size=16, scan_chunk=10)
        cfg["diff"]["denoiser"].update(hidden_dim=64, num_blocks=2,
                                       partial_points=32)


# cells out of BENCHMARK.json whose driver, traffic, limits and readers
# stay under benchmark/: (configuration, traffic, per-layer metrics)
PARKED = {"c4.serve.batch64": ("config4_conditional", "serve_batch64",
                               ["device.idle_pct.serve", "serve.mesh_cpu_ms",
                                "fused_eval_roofline", "mfu.serve"])}


def load_cell(name: str) -> tuple:
    """run.load_cell, and the same for a parked cell."""
    if name not in PARKED:
        return RUN_LOAD_CELL(name)
    config, traffic, _ = PARKED[name]
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{config}.json").read_text())
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / f"{traffic}.json").read_text())
    cell = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    return manifest(), cell, cfg, mix


def small_pack(load, codes: int = 64):
    """A pack reader that keeps the first `codes` codes."""
    def cut(path, device):
        params, table = load(path, device)
        return params, table[:codes]
    return cut


@pytest.fixture
def few_codes(monkeypatch):
    from benchmark.reference import decoder as ref
    monkeypatch.setattr(ref, "load_pack", small_pack(ref.load_pack))


@pytest.fixture
def tiny(monkeypatch, few_codes):
    """run.load_cell patched to cut every cell, parked ones too, to a CPU
    test's size."""
    def load(name):
        manifest_, cell, cfg, traffic = load_cell(name)
        shrink(name, cfg, traffic)
        return manifest_, cell, cfg, traffic

    monkeypatch.setattr(run, "load_cell", load)
    return run


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
