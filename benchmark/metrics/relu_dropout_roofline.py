"""ops.relu_dropout (kernels #3 and #3b): the bytes bound of relu +
dropout and its backward at the decoder's hidden widths over the device
time of csrc/relu_dropout.cu's kernels in the traced steps."""

from benchmark import kernels
from benchmark.readers import roofline_pct
from benchmark.yardstick import relu_dropout_bound_ms


def read(ctx):
    ad = ctx.cfg["ad"]
    rows = ad["scenes_per_batch"] * ad["samples_per_scene"]
    bound = relu_dropout_bound_ms(ad["decoder"], rows) / 1e3
    return roofline_pct(ctx, bound * ctx.driver.trace_work["steps"],
                        kernels.of(kernels.RELU_DROPOUT))
