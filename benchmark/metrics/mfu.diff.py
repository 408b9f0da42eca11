"""train.diffusion + models.denoiser: the stage-2 step's FLOPs counted
from the denoiser's shapes (benchmark.yardstick.denoiser_step_flops,
forward and backward at the configured batch, classifier-free dropout
included) times the traced work's steps, over that work's time untraced
at the bf16 dense peak of 989 TFLOP/s; the step's products are fp32 by
design, so this reads far below 100."""

from benchmark.readers import mfu_pct


def read(ctx):
    d = ctx.driver
    return mfu_pct(ctx, d.step_flops * d.trace_work["steps"])
