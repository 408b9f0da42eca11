"""models.decoder on the autograd route, backward: the device time of the
span `ad.backward` (autograd's backward of the forward: #3b, the dgrad
and wgrad products, the cat's and the weight norm's backward, the code
table's dense gradient) a step in the traced steps."""

from benchmark.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ad.backward")
