"""The device trace of a traced run, read in memory.

`profile_window` is chip_smoke.device_profile (chip_smoke.py:355 at the
commit that introduced the benchmark) reshaped to keep the events: the
warm-up runs first inside the same trace, the card idles 50 ms, and only
events that start after the middle of that gap count, because the
profiler can drop the first launches of a trace. No Chrome trace is
written.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, NamedTuple

NAME_CHARS = 160        # a breakdown's names, cut: templates run long


class Trace(NamedTuple):
    window_s: float        # the measured part, ended by a synchronize
    kernels: list          # [(name, start_us, end_us)] device spans
    host_ops: list         # [(name, start_us, end_us)] host ops
    t0_us: float           # the measured part's start on the trace clock
    t1_us: float           # ... and its end

    def busy_us(self) -> float:
        """Union of the device spans inside the window."""
        busy, reach = 0.0, float("-inf")
        for s, e in sorted((max(s, self.t0_us), min(e, self.t1_us))
                           for _, s, e in self.kernels):
            if e <= s:
                continue
            busy += max(0.0, e - max(s, reach))
            reach = max(reach, e)
        return busy

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Summed device seconds of the spans whose name matches."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def top_ops(self, k: int = 10) -> list:
        """The k device operations that took most time, by name (cut to
        NAME_CHARS characters)."""
        by: dict = {}
        for n, s, e in self.kernels:
            by[n[:NAME_CHARS]] = by.get(n[:NAME_CHARS], 0.0) + (e - s) / 1e6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10, longest: int = 500) -> list:
        """Idle time of the device inside the window, summed by the
        innermost host op running at each gap's midpoint (or "host:
        between ops"), the largest first. The `longest` gaps are named;
        the rest are summed as "shorter gaps"."""
        gaps, reach = [], self.t0_us
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if s > reach:
                gaps.append((reach, min(s, self.t1_us)))
            reach = max(reach, e)
        if reach < self.t1_us:
            gaps.append((reach, self.t1_us))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])
        ops = sorted(self.host_ops, key=lambda r: r[1])
        starts = [s for _, s, _ in ops]
        by: dict = {}
        for a, b in gaps[:longest]:
            mid = (a + b) / 2
            name = "host: between ops"
            # the innermost op holding mid is the latest-starting one
            for i in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 4000),
                           -1):
                if ops[i][2] >= mid:
                    name = ops[i][0]
                    break
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        rest = sum(b - a for a, b in gaps[longest:]) / 1e6
        if rest:
            by["shorter gaps"] = rest
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]


def profile_window(fn: Callable[[], None], warmup: Callable[[], None]
                   ) -> Trace:
    """Run warmup() then fn() under torch.profiler (CPU and CUDA
    activities), each ended by a synchronize; return fn()'s part."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.warmup"):
            warmup()
            torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function("bench.measured"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    # the host's ranges: the device's user annotations of the same names
    # span only the kernels they launched
    mark = {e.name: e.time_range for e in events
            if e.name.startswith("bench.") and e.device_type == DeviceType.CPU}
    start = (mark["bench.warmup"].end + mark["bench.measured"].start) / 2
    t0, t1 = mark["bench.measured"].start, mark["bench.measured"].end
    kernels, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if s < start or e.name.startswith("bench."):
            continue
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue        # a host op's name over its device span
            kernels.append((e.name, float(s), float(t)))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, float(s), float(t)))
    return Trace((t1 - t0) / 1e6, kernels, host, float(t0), float(t1))
