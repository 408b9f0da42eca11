"""The comparisons that decide `correct`, and the limits they are held to.

Each cell's limits sit in benchmark/limits/<cell>.json:
{"<number>": {"limit": x, "lower": program's largest reading over its
seeds, "upper": the control's (or a fault's) smallest}, ...}. A number is
correct when it is at most its limit; an exact comparison has the limit 0.
"""

from __future__ import annotations

import json
import math
import pathlib
import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Laps(dict):
    """Set-up phases' seconds by name, each ended by a synchronize."""

    def __init__(self, device):
        super().__init__()
        self.device, self.mark = device, time.perf_counter()

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self[name] = now - self.mark
        self.mark = now


def rel_gap(got: float, ref: float) -> float:
    return abs(float(got) - float(ref)) / max(abs(float(ref)), 1e-30)


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gap_table(got: dict, ref: dict, moving: dict | None = None
                   ) -> dict:
    """The gap of norms of each leaf: |‖got‖ - ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖. With `moving` (the reference's
    first gradients), a leaf whose gradient is under a thousandth of the
    median leaf's is left out: it moves by round-off alone."""
    keys = sorted(ref)
    if moving is not None:
        gn = {k: norm(moving[k]) for k in keys}
        med_g = sorted(gn.values())[len(gn) // 2]
        keys = [k for k in keys if gn[k] >= 1e-3 * med_g]
    rn = {k: norm(ref[k]) for k in keys}
    med = sorted(rn.values())[len(rn) // 2]
    return {k: abs(norm(got[k]) - rn[k]) / max(rn[k], med, 1e-30)
            for k in keys}


def load_limits(root: pathlib.Path, cell: str) -> dict:
    path = root / "benchmark" / "limits" / f"{cell}.json"
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit]]) over every limit; a number
    missing or not finite is not correct."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        rows.append([name, v, limit])
    return ok, rows
