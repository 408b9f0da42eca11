"""The benchmark on the card: a short traced run of each cell, whose
per-layer metrics are all there and whose shares of a roofline or a peak
read at most 100. Marked `gpu`: each skips without a card. On the card:

    python -m pytest benchmark/tests/test_bench_card.py -m gpu -q
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "424242", "--seconds", "2",
                          "--trace", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    want = {m["name"] for m in manifest()["per_layer"]
            if cell in m.get("workloads", CELLS)}
    assert set(res["metrics"]) == want
    for name, v in res["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < v["value"] <= 100, (name, v)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"] * 1.001
    assert len(res["breakdown"]["device_ops"]) <= 10
