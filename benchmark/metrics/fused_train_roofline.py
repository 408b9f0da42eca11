"""ops.fused_train (kernel #4, every launch of a pass): the pass's
operations bound, the step's FLOPs at 989 TFLOP/s (10.00 ms for config
3's step), over the device time of csrc/fused_train.cu's kernels in the
traced steps."""

from benchmark import kernels
from benchmark.readers import roofline_pct
from benchmark.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    d = ctx.driver
    bound = d.step_flops / PEAK_BF16_FLOPS * d.trace_work["steps"]
    return roofline_pct(ctx, bound, kernels.of(kernels.FUSED_TRAIN))
