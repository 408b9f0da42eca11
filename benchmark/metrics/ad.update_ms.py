"""train.auto_decoder: the device time of the span `ad.update` (the lr,
the gradient norms the step logs, Adam's update of the decoder and the
code table) a step in the traced steps."""

from benchmark.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ad.update")
