"""data.device_bank: the device time of the span `ad.draw` (the balanced
draw from the bank: the uniforms and the gathers) a step in the traced
steps."""

from benchmark.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ad.draw")
