"""The launcher of cells on more than one card (benchmark/ranks.py), run
through run.main with the probe driver (rank_probe.py) on CPU ranks over
gloo, at 2 and at 4 ranks: one result line, from rank 0, with the
fullest device's peak, the worst reading over the ranks and the ranks'
counts summed; the same calls on every rank; and a rank that raises,
hangs or loads JAX ending the run with no result and no process left.
The last test runs the probe over NCCL on 4 cards (marked gpu).
"""

import json
import os
import pathlib
import subprocess
import sys
import time
import uuid
from typing import NamedTuple

import pytest

from conftest import ROOT
from rank_probe import LIMIT, peak_of

HERE = ROOT / "benchmark" / "tests"
RANKS = [2, 4]
UNTRACED = ["init", "run", "free", "check", "counts"]
TRACED = ["init", "warm", "work", "warm", "work", "free", "check", "counts"]


class Done(NamedTuple):
    rc: int
    out: str
    err: str
    seconds: float
    log: pathlib.Path
    tag: str


def launch(tmp_path, n, device="cpu", trace=0, setup_s=None, **traffic):
    log = tmp_path / "log"
    log.mkdir(parents=True)
    spec = {"chips": n, "device": device,
            "traffic": {"driver": "probe", "log": str(log), "planted": 1.0,
                        **traffic}}
    if setup_s is not None:
        spec["setup_s"] = setup_s
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    stub = tmp_path / "stub"                    # `import jax` finds this
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    tag = uuid.uuid4().hex
    env = dict(os.environ, RANK_PROBE_TAG=tag, PYTHONPATH=os.pathsep.join(
        [str(stub), str(ROOT), str(HERE)]))
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, "-c", "import rank_probe; rank_probe.main()",
         str(tmp_path / "spec.json"), "--workload", "probe", "--seed",
         "2147483659", "--seconds", "0.2", "--trace", str(trace)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    return Done(p.returncode, p.stdout, p.stderr, time.monotonic() - t0,
                log, tag)


def result(done: Done) -> dict:
    """The one JSON line, which is the last line of stdout."""
    lines = [s for s in done.out.splitlines() if s.strip()]
    found = [s for s in lines if s.lstrip().startswith("{")]
    assert len(found) == 1 and found[0] == lines[-1], done.out
    return json.loads(lines[-1])


def no_result(done: Done) -> None:
    assert not any(s.lstrip().startswith("{")
                   for s in done.out.splitlines()), done.out


def calls(done: Done, rank: int) -> list:
    rows = [json.loads(s) for s in
            (done.log / f"rank{rank}.jsonl").read_text().splitlines()]
    return [r["call"] for r in rows if "call" in r]


def left_behind(tag: str, wait_s: float = 3.0) -> list:
    """Live processes that carry the run's tag in their environment."""
    needle = f"RANK_PROBE_TAG={tag}".encode()
    t_end = time.monotonic() + wait_s
    while True:
        found = []
        for d in pathlib.Path("/proc").iterdir():
            if not d.name.isdigit():
                continue
            try:
                if needle in (d / "environ").read_bytes().split(b"\0"):
                    found.append(int(d.name))
            except OSError:
                continue
        if not found or time.monotonic() > t_end:
            return found
        time.sleep(0.1)


@pytest.mark.parametrize("n", RANKS)
def test_one_result_line_from_rank_0(tmp_path, n):
    done = launch(tmp_path, n)
    assert done.rc == 0, done.err[-4000:]
    out = result(done)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == n
    assert out["device"]["memory_peak_bytes"] == max(
        peak_of(r) for r in range(n))
    assert out["attempted"] == sum(10 + r for r in range(n))
    assert out["failed"] == sum(r % 2 for r in range(n))
    assert out["metrics"]["probe_ms"]["value"] == 1.0       # rank 0's
    assert out["metrics"]["setup_s"]["value"] > 0
    worst = LIMIT * n / 10                                  # rank n-1's
    assert out["checks"] == {"probe_gap": {"value": worst, "limit": LIMIT}}
    for r in range(n):
        assert calls(done, r) == UNTRACED
    assert left_behind(done.tag) == []


@pytest.mark.parametrize("n", RANKS)
def test_traced_run_makes_the_same_calls_on_every_rank(tmp_path, n):
    done = launch(tmp_path, n, trace=1)
    assert done.rc == 0, done.err[-4000:]
    out = result(done)
    assert out["correct"] is True and out["device"]["count"] == n
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for r in range(n):
        assert calls(done, r) == TRACED
    assert left_behind(done.tag) == []


@pytest.mark.parametrize("n", RANKS)
def test_a_reading_over_its_limit_on_one_rank_is_not_correct(tmp_path, n):
    bad = min(2, n - 1)
    done = launch(tmp_path, n, plant_on=bad)
    assert done.rc == 0, done.err[-4000:]
    out = result(done)
    assert out["correct"] is False
    assert out["checks"]["probe_gap"]["value"] == 1.0
    assert "ranks probe_gap:" in done.err


@pytest.mark.parametrize("n", RANKS)
def test_a_rank_that_raises_ends_the_run(tmp_path, n):
    done = launch(tmp_path, n, raise_on=n - 1)
    assert done.rc not in (0, None) and done.seconds < 60
    no_result(done)
    assert f"rank {n - 1} failed" in done.err
    assert "planted failure" in done.err
    assert left_behind(done.tag) == []


@pytest.mark.parametrize("n", RANKS)
def test_a_rank_past_the_limit_is_killed(tmp_path, n):
    done = launch(tmp_path, n, setup_s=10.0, sleep_on=n - 1)
    assert done.rc not in (0, None) and done.seconds < 60
    no_result(done)
    assert "not done within 10.2 s" in done.err
    assert left_behind(done.tag) == []


@pytest.mark.parametrize("n", RANKS)
def test_jax_in_a_child_exits_3(tmp_path, n):
    done = launch(tmp_path, n, jax_on=n - 1)
    assert done.rc == 3, done.err[-4000:]
    no_result(done)
    assert f"forbidden modules loaded: ['jax'] (ranks [{n - 1}])" in done.err
    assert left_behind(done.tag) == []


@pytest.mark.gpu
def test_probe_over_nccl_on_4_cards(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    for trace in (0, 1):
        done = launch(tmp_path / f"t{trace}", 4, device="cuda", trace=trace)
        assert done.rc == 0, done.err[-4000:]
        out = result(done)
        assert out["correct"] is True and out["device"]["count"] == 4
        assert out["device"]["platform"] == "gpu"
        assert out["device"]["memory_peak_bytes"] > 0
        if trace:
            assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for r in range(4):
            assert calls(done, r) == (TRACED if trace else UNTRACED)
        assert left_behind(done.tag) == []
    done = launch(tmp_path / "raise", 4, device="cuda", raise_on=2)
    assert done.rc not in (0, None) and done.seconds < 120
    no_result(done)
    assert "rank 2 failed" in done.err
    assert left_behind(done.tag) == []
