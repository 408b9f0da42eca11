"""The device's idle share: 100 - the union of its device spans (kernels
and copies) in the traced work over the same work's time on the host
clock, run just before without the profiler."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
