"""A probe cell for the launcher's tests (test_bench_ranks.py), kept out
of benchmark/drivers/ so that no cell can name it.

Every call of its Driver does one `all_reduce` of a tensor that depends
on its rank, checks the sum, and logs the call's name to
<log>/rank<k>.jsonl (after the process id). The traffic plants faults on
one rank: `raise_on` raises in set-up, `sleep_on` sleeps in the window,
`jax_on` imports a module named `jax` after it, `plant_on` reads
`planted` where the others read under the limit.

    python -c "import rank_probe; rank_probe.main()" <spec.json> \\
        --workload probe --seed 1 --seconds 0.2 --trace 0

with benchmark/ and this folder on PYTHONPATH runs the probe as rank 0
through run.main: run.load_cell, the launcher's Driver class and, on the
CPU, its Card patched here, in rank 0 alone.
"""

import json
import os
import pathlib
import sys
import time

import torch
import torch.distributed as dist

LIMIT = 0.01


class Driver:

    def __init__(self, cfg, traffic, seed, device, seconds):
        self.traffic, self.dev = traffic, device
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.log = pathlib.Path(traffic["log"]) / f"rank{self.rank}.jsonl"
        self.log.write_text(json.dumps({"pid": os.getpid()}) + "\n")
        self.keep = torch.zeros(1024 * (self.rank + 1), device=device)
        self.phases = {"probe": 0.0}
        self._call("init")
        if traffic.get("raise_on") == self.rank:
            raise RuntimeError(f"probe: planted failure on rank {self.rank}")

    def _call(self, name: str) -> None:
        x = torch.full((4,), float(self.rank + 1), device=self.dev)
        dist.all_reduce(x)
        if float(x[0]) != self.world * (self.world + 1) / 2:
            raise RuntimeError(f"probe: {name}'s all_reduce read {x}")
        with self.log.open("a") as f:
            f.write(json.dumps({"call": name}) + "\n")

    def run(self, seconds):
        self._call("run")
        if self.traffic.get("sleep_on") == self.rank:
            time.sleep(600)
        return {"probe_ms": 1.0 + self.rank}

    def traced(self):
        return (lambda: self._call("warm")), (lambda: self._call("work"))

    def free(self):
        self._call("free")
        del self.keep

    def check(self):
        self._call("check")
        if self.traffic.get("jax_on") == self.rank:
            import jax  # noqa: F401  (a stub on the children's path)
        planted = self.traffic.get("plant_on") == self.rank
        return {"probe_gap": self.traffic["planted"] if planted
                else LIMIT * (self.rank + 1) / 10}

    def counts(self):
        self._call("counts")
        return 10 + self.rank, self.rank % 2


class Card:
    """A CPU rank's stand-in for the card's readers: the profiled pair
    runs on the host clock, and the peak is one of each rank's own."""

    @staticmethod
    def profile(work, warm):
        from benchmark.devtrace import Trace
        warm()
        t0 = time.perf_counter()
        work()
        window_us = (time.perf_counter() - t0) * 1e6
        return Trace(window_us / 1e6, [("probe", 0.0, window_us / 2)], [],
                     0.0, window_us)

    @staticmethod
    def peak_bytes(device) -> int:
        return peak_of(dist.get_rank())


def peak_of(rank: int) -> int:
    return 1000 * (rank + 1) + 7


def manifest(chips: int) -> dict:
    return {"end_to_end": [
                {"name": "probe_ms", "unit": "ms", "better": "lower",
                 "bound": 0.01, "source": "host_clock"},
                {"name": "setup_s", "unit": "s", "better": "lower",
                 "bound": 0.25, "source": "host_clock"}],
            "per_layer": [],
            "workloads": [{"name": "probe", "config": "probe",
                           "traffic": "probe", "chips": chips}]}


def main() -> None:
    spec = json.loads(pathlib.Path(sys.argv[1]).read_text())
    from benchmark import checks, ranks, run
    m = manifest(spec["chips"])
    run.load_cell = lambda name: (m, m["workloads"][0], {}, spec["traffic"])
    ranks.driver_class = lambda traffic: Driver
    checks.load_limits = lambda root, cell: {"probe_gap": LIMIT}
    ranks.SETUP_S = spec.get("setup_s", ranks.SETUP_S)
    device = None
    if spec["device"] == "cpu":
        ranks.Card = Card
        device = torch.device("cpu")
    sys.exit(run.main(sys.argv[2:], device))
