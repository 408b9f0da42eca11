"""models.decoder on the autograd route: the device time of the span
`ad.forward` (the codes' gather, the decoder's forward through
ops.bf16_linear and #3, the skip cat, the fp32 head, the clamped L1 and
the code regularisation) a step in the traced steps."""

from benchmark.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ad.forward")
