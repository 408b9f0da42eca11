"""A cell on more than one card: one process per card, joined in one
process group, judged on rank 0.

The process that `run.py` starts is rank 0. It has loaded the cell, and
starts ranks 1 .. n-1 as its own children (`spawn`: CUDA forbids fork),
handing each a `Plan`: the cell as loaded, the Driver class and the card's
readers, by reference, so every rank runs what rank 0 read. Rank k takes
cuda:k; all ranks join one group (NCCL on cards, gloo on CPU ranks, which
only tests use) at localhost on a port rank 0 picked, with a timeout,
before any driver is built. A driver reads its rank and the world's size
from `torch.distributed`.

Every rank makes the same calls in the same order (`_rank`), so each
collective meets. Untraced: a barrier, then `driver.run`; the end-to-end
metrics and `setup_s` (rank 0's process start to its first timed step,
the ranks' start included) are rank 0's. Traced: warm, work, each ended
by a synchronize (`untraced_s`), then warm and work under the profiler on
every rank; `busy_s` and `window_s` are the ranks' means, and the
per-layer readers and the breakdown read rank 0's trace alone. A
collective's device time on rank 0 includes its wait for the slowest
rank. Then every rank reads its device's peak, frees, checks, looks for
JAX in its `sys.modules` and counts; the children send what they found to
rank 0 through a pipe and end.

Rank 0 prints the one result line: the fullest device's peak, each
compared number at its worst over the ranks (the largest, since every
limit is an upper bound; missing or not finite on any rank is not
correct), `attempted` and `failed` summed. JAX in any rank exits 3. A
rank that raises, exits without a result or is not done within
`limit_s` ends the run: rank 0 names it on stderr, kills every child and
exits 1 with no result line. A child dies with rank 0 however rank 0
ends (`PR_SET_PDEATHSIG`).

What rank 0 patches in its own process (a test's fault, a cut pack
reader) does not reach the children: a test that runs a cut cell through
here hands its cuts in the configuration and traffic that `run.load_cell`
returns.
"""

from __future__ import annotations

import ctypes
import datetime
import importlib
import math
import multiprocessing as mp
import multiprocessing.connection
import os
import signal
import socket
import sys
import threading
import time
import traceback
from typing import NamedTuple

import torch

from benchmark import checks

# a rank's set-up (a checkout's first run builds every kernel: the
# contract allows it 1200 s), the traced work and the check after the
# window; the limit of a run is this plus its window
SETUP_S = 1100.0
GRACE_S = 5.0       # rank 0 failed: how long a child's failure may take
#                     to show, since it would be the cause


class Card:
    """What a rank reads of its device. The launcher's CPU tests hand in
    a stand-in: a CPU has no device trace."""

    @staticmethod
    def profile(work, warm):
        from benchmark.devtrace import profile_window
        return profile_window(work, warm)

    @staticmethod
    def peak_bytes(device) -> int:
        return (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)


class Plan(NamedTuple):
    """A loaded cell and how to run it: what rank 0 hands each child."""
    seed: int
    seconds: float
    trace: int
    manifest: dict
    cell: dict
    cfg: dict
    traffic: dict
    driver: type            # the traffic's Driver class
    card: type              # Card, or a test's stand-in
    device_type: str        # "cuda"; "cpu" in tests
    world: int
    port: int
    limit_s: float
    parent: int             # rank 0's pid


def driver_class(traffic: dict) -> type:
    return importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}").Driver


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(args, loaded: tuple, device, t_start: float) -> dict:
    """`run.run` for a cell with `chips` > 1, as rank 0; returns the
    result line's object. `device` None asks for the cards."""
    manifest, cell, cfg, traffic = loaded
    n = cell["chips"]
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n:
            raise SystemExit(f"{cell['name']} needs {n} CUDA device(s); "
                             f"found {found}")
        device_type = "cuda"
    else:
        device_type = device.type
    plan = Plan(int(args.seed), float(args.seconds), int(args.trace),
                manifest, cell, cfg, traffic, driver_class(traffic), Card,
                device_type, n, _free_port(),
                SETUP_S + float(args.seconds), os.getpid())
    return launch(plan, t_start)


def launch(plan: Plan, t_start: float) -> dict:
    ctx = mp.get_context("spawn")
    kids: dict = {}
    watch = Watch(kids, plan.limit_s)
    try:
        for rank in range(1, plan.world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=child, args=(plan, rank, send),
                            name=f"rank{rank}")
            p.start()
            send.close()
            kids[rank] = (p, recv)
        watch.start()
        mine = _rank(plan, 0, t_start)
        theirs = watch.wait()
    except BaseException as e:     # every child goes with rank 0
        watch.abort(e)
    _stop_tracker()
    return _result(plan, [mine] + [theirs[r] for r in sorted(theirs)])


def child(plan: Plan, rank: int, conn) -> None:
    """A child rank's process: its result, or its traceback, to rank 0."""
    t_start = time.perf_counter()
    os.dup2(2, 1)                  # stdout is rank 0's result line alone
    _die_with_parent(plan.parent)
    try:
        msg = _rank(plan, rank, t_start)
    except BaseException:
        conn.send({"rank": rank, "error": traceback.format_exc()})
        conn.close()
        os._exit(1)
    conn.send(msg)
    conn.close()


def _die_with_parent(parent: int) -> None:
    """SIGKILL for this process when rank 0 ends, however it ends."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(1, signal.SIGKILL, 0, 0, 0) != 0:     # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:     # rank 0 ended before the line above
        os._exit(1)


def _rank(plan: Plan, rank: int, t_start: float) -> dict:
    """One rank's calls, the same on every rank and in the same order;
    rank 0 also keeps its end-to-end or per-layer metrics."""
    import torch.distributed as dist
    from benchmark import run as harness
    cuda = plan.device_type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://localhost:{plan.port}", world_size=plan.world,
        rank=rank, timeout=datetime.timedelta(seconds=plan.limit_s))

    def barrier():
        if cuda:
            dist.barrier(device_ids=[rank])
        else:
            dist.barrier()

    t_import = time.perf_counter() - t_start
    driver = plan.driver(plan.cfg, plan.traffic, plan.seed, dev,
                         plan.seconds)
    sys.stderr.write(      # one write: the ranks share the stream
        f"rank {rank} set-up: {t_import:.2f} s to the driver, then "
        + ", ".join(f"{k} {v:.2f} s" for k, v in
                    getattr(driver, "phases", {}).items()) + "\n")
    sys.stderr.flush()
    out: dict = {"rank": rank}
    if plan.trace:
        warm, work = driver.traced()
        warm()
        checks.sync(dev)
        t0 = time.perf_counter()
        work()
        checks.sync(dev)
        untraced_s = time.perf_counter() - t0
        trace = plan.card.profile(work, warm)
        out.update(busy_s=trace.busy_us() / 1e6, window_s=trace.window_s)
        if rank == 0:
            ctx = harness.Context(plan.cell, plan.cfg, plan.traffic, driver,
                                  trace, untraced_s)
            out["metrics"] = harness.layer_metrics(plan.manifest, ctx)
            out["breakdown"] = {"device_ops": trace.top_ops(10),
                                "idle_gaps": trace.idle_gaps(10)}
    else:
        barrier()
        setup_s = time.perf_counter() - t_start
        e2e = driver.run(plan.seconds)
        if rank == 0:
            out["metrics"] = harness.e2e_metrics(plan.manifest, plan.cell,
                                                 e2e, setup_s)
    out["memory_peak_bytes"] = plan.card.peak_bytes(dev)
    driver.free()
    out["readings"] = driver.check()
    out["forbidden"] = harness.forbidden_modules()
    out["attempted"], out["failed"] = driver.counts()
    barrier()
    dist.destroy_process_group()
    return out


def worst(values: list):
    """A compared number at its worst over the ranks: the largest, or the
    first that is missing or not finite."""
    for v in values:
        if v is None or not math.isfinite(v):
            return v
    return max(values)


def _result(plan: Plan, ranks: list) -> dict:
    """Rank 0's result line from every rank's findings."""
    found = sorted({m for r in ranks for m in r["forbidden"]})
    if found:
        where = [r["rank"] for r in ranks if r["forbidden"]]
        print(f"forbidden modules loaded: {found} (ranks {where})",
              file=sys.stderr)
        raise SystemExit(3)
    from benchmark import run as harness
    limits = checks.load_limits(harness.ROOT, plan.cell["name"])
    names = list(limits) + sorted({k for r in ranks for k in r["readings"]}
                                  - set(limits))
    for name in names:
        print(f"ranks {name}: "
              f"{[r['readings'].get(name) for r in ranks]!r}",
              file=sys.stderr)
    correct, rows = checks.judge(
        {k: worst([r["readings"].get(k) for r in ranks]) for k in names},
        limits)
    cuda = plan.device_type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": plan.world}
    extra = {}
    if plan.trace:
        device["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = sum(r["window_s"] for r in ranks) / len(ranks)
        extra["breakdown"] = ranks[0]["breakdown"]
    device["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in ranks)
    for name, v, lim in rows:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    return {"correct": correct,
            "attempted": sum(r["attempted"] for r in ranks),
            "failed": sum(r["failed"] for r in ranks),
            "metrics": ranks[0]["metrics"], "device": device, **extra,
            "checks": {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}}


class Watch(threading.Thread):
    """Rank 0's watch over its children. It takes each child's result
    and its exit; a child that reports an error, exits other than 0 or
    without a result, or is not done by the deadline ends the run."""

    def __init__(self, kids: dict, limit_s: float):
        super().__init__(name="ranks-watch", daemon=True)
        self.kids, self.limit_s = kids, limit_s
        self.deadline = time.monotonic() + limit_s
        self.results: dict = {}
        self.done = threading.Event()
        self.lock = threading.Lock()   # whoever takes it ends the process

    def run(self) -> None:
        ended: set = set()
        closed: set = set()
        while len(ended) < len(self.kids):
            objs = {}
            for r, (p, conn) in self.kids.items():
                if r not in ended:
                    objs[p.sentinel] = r
                    if r not in closed and r not in self.results:
                        objs[conn] = r
            left = self.deadline - time.monotonic()
            ready = mp.connection.wait(list(objs), timeout=max(left, 0.0))
            if not ready and left <= 0:
                late = sorted(set(self.kids) - ended)
                self.fail(f"rank(s) {late} not done within "
                          f"{self.limit_s:.1f} s")
            # a child sends, then ends: its message first
            for obj in sorted(ready, key=lambda o: isinstance(o, int)):
                r = objs[obj]
                p, conn = self.kids[r]
                if obj is conn:
                    self._take(r, conn, closed)
                    continue
                p.join()
                if r not in self.results and r not in closed and conn.poll():
                    self._take(r, conn, closed)
                if p.exitcode != 0:
                    self.fail(f"rank {r} exited with code {p.exitcode}")
                if r not in self.results:
                    self.fail(f"rank {r} exited without a result")
                ended.add(r)
        self.done.set()

    def _take(self, r: int, conn, closed: set) -> None:
        try:
            msg = conn.recv()
        except EOFError:
            closed.add(r)
            return
        if "error" in msg:
            self.fail(f"rank {r} failed:\n{msg['error']}")
        self.results[r] = msg

    def wait(self) -> dict:
        """Every child's result, once every child has ended with 0."""
        while not self.done.wait(1.0):
            pass
        return self.results

    def fail(self, why: str) -> None:
        self.lock.acquire()
        print(f"ranks: {why.rstrip()}\nranks: killing every child",
              file=sys.stderr, flush=True)
        self._end(1)

    def abort(self, exc: BaseException) -> None:
        """Rank 0 raised: name the cause, end every child, exit."""
        if self.is_alive():
            self.join(GRACE_S)     # a child's failure is the cause
        self.lock.acquire()
        code = 1
        if isinstance(exc, SystemExit):
            if isinstance(exc.code, int):
                code = exc.code
            elif exc.code is not None:
                print(exc.code, file=sys.stderr)
        else:
            traceback.print_exception(exc, file=sys.stderr)
        print("ranks: rank 0 failed; killing every child", file=sys.stderr,
              flush=True)
        self._end(code)

    def _end(self, code: int) -> None:
        sys.stderr.flush()
        for p, _ in self.kids.values():
            if p.is_alive():
                p.kill()
        for p, _ in self.kids.values():
            p.join(30)
        if not any(p.is_alive() for p, _ in self.kids.values()):
            _stop_tracker()
        os._exit(code)


def _stop_tracker() -> None:
    """Stop and wait for multiprocessing's resource tracker, which
    `spawn` starts, so that no process outlives rank 0."""
    from multiprocessing import resource_tracker
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
