"""serve, the whole batch: the decoder FLOPs of the points the decode
needs (latent products hoisted) over the batch's time untraced at the
bf16 peak."""

from benchmark.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, ctx.driver.eval_flops())
