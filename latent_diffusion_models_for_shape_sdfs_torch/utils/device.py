"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device with an explicit index for CUDA (so it
    compares equal to a tensor's `.device`); raises when it names CUDA and
    no card is present. Entry points default to "cuda", so a caller on a
    machine without a card must ask for the CPU (`device="cpu"`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
