"""Per-layer metrics read from the program's spans
(`utils.profiling.span`): a span's device time a step in the traced
work."""

from __future__ import annotations


def per_step_ms(ctx, name: str):
    """The device time of the span `name` in the traced work over its
    steps, in ms. The work's count of the span is the number of its host
    ranges in the trace, from which the warm-up is cut off; the newest
    that many of the program's records of it (`span_records`) are the
    work's, and their device times are summed. None where the trace holds
    no such range, the program keeps no spans, or no record has a device
    time."""
    n = sum(1 for op, _, _ in ctx.trace.host_ops if op == name)
    if not n:
        return None
    from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
    records = getattr(profiling, "span_records", None)
    if records is None:
        return None
    device = [d for _, d in records(name, last=n) if d is not None]
    if not device:
        return None
    return 1e3 * sum(device) / ctx.driver.trace_work["steps"]
