"""Shared arithmetic of the per-layer metrics' readers
(benchmark/metrics/<metric>.py). A reader returns None where its cell
has nothing for it to read; a share of a roofline or a peak is never 0
for want of a reading."""

from __future__ import annotations

from benchmark.yardstick import PEAK_BF16_FLOPS


def idle_pct(ctx):
    """100 - the device's busy time in the traced work over the same
    work's time untraced."""
    t = ctx.trace
    if not t.kernels or ctx.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / ctx.untraced_s)


def mfu_pct(ctx, flops: float):
    """`flops`, the traced work's, over the same work's time untraced at
    the bf16 peak."""
    if not flops or ctx.untraced_s <= 0:
        return None
    return 100.0 * flops / (ctx.untraced_s * PEAK_BF16_FLOPS)


def roofline_pct(ctx, bound_s: float, match):
    """The least time of the work over the device time of the kernels
    that `match` names; None where none ran."""
    spent = ctx.trace.device_s(match)
    if spent <= 0 or not bound_s:
        return None
    return 100.0 * bound_s / spent
