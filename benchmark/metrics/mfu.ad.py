"""The stage-1 step's share of the bf16 peak: the step's FLOPs counted
from the configuration's shapes (benchmark.yardstick.train_step_flops,
the same whatever route runs the step) times the traced work's steps,
over that work's time untraced at 989 TFLOP/s."""

from benchmark.readers import mfu_pct


def read(ctx):
    d = ctx.driver
    return mfu_pct(ctx, d.step_flops * d.trace_work["steps"])
