"""Whole runs of each cell on the CPU at a tiny size, the look for a chip
skipped: the last line's schema, correct true, and correct false with the
timed path broken underneath."""

import io
import json
import types
from contextlib import redirect_stdout

import pytest
import torch

from conftest import PARKED, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


def _args(cell, seed=7, trace=0):
    return types.SimpleNamespace(workload=cell, seed=seed, seconds=0.2,
                                 trace=trace)


@pytest.mark.parametrize("cell", CELLS)
def test_last_line_schema(tiny, cell):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tiny.main(["--workload", cell, "--seed", "3", "--seconds",
                          "0.2", "--trace", "0"], torch.device("cpu")) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    m = manifest()
    want = {e["name"] for e in m["end_to_end"]
            if cell in e.get("workloads", CELLS)}
    assert set(out["metrics"]) == want
    for v in out["metrics"].values():
        assert v["value"] > 0 and isinstance(v["unit"], str)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


FAULTS = {"c3.train.bank": ["unchanged", "half_batch", "db_halved",
                            "labels_bf16"],
          "c3.train.fused": ["unchanged", "half_batch", "labels_bf16"],
          "c4.diff.train": ["unchanged", "half_batch_diff"],
          "c4.serve.batch64": ["swapped"]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS + list(PARKED)
                                        for f in FAULTS.get(c, [])])
def test_fault_comes_out_not_correct(tiny, cell, fault):
    from benchmark import faults
    with faults.FAULTS[fault]():
        out = tiny.run(_args(cell), device=torch.device("cpu"))
    assert out["correct"] is False, out["checks"]


def test_no_chip_exits_without_a_result(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tiny.run(_args(CELLS[0]))
    assert e.value.code not in (0, None)
