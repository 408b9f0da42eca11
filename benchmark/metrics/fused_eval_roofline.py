"""ops.grid_eval's sparse decode through kernel #1: the operations bound
of the points the three-level decode needs for these latents (the active
counts, not the caps) over the device time of csrc/fused_eval.cu's
kernel in the traced batch."""

from benchmark import kernels
from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ctx.driver.eval_bound_s(),
                        kernels.of(kernels.FUSED_EVAL))
