"""ops.bf16_linear: the least time of all the decoder's matrix products in
the traced steps (benchmark.yardstick.products_bound_ms) over the device
time of cuBLAS's and CUTLASS's product kernels; in a cell on the
autograd route only the decoder's products launch them."""

from benchmark import kernels
from benchmark.readers import roofline_pct
from benchmark.yardstick import products_bound_ms


def read(ctx):
    ad = ctx.cfg["ad"]
    rows = ad["scenes_per_batch"] * ad["samples_per_scene"]
    bound = products_bound_ms(ad["decoder"], rows) / 1e3
    return roofline_pct(ctx, bound * ctx.driver.trace_work["steps"],
                        kernels.library_gemm)
