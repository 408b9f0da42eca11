"""train.diffusion + models.denoiser: the device time of the span
`diff.steps` (a chunk's graph replays, with the gaps between them) a step
in the traced chunks, without the chunk's draws, copy-in and the read
of its loss."""

from benchmark.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "diff.steps")
