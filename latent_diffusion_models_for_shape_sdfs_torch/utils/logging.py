"""JSONL metric logging + throughput timing.

Counterpart of the JAX package's `utils/logging.py`: every run writes a
JSONL event stream (step, losses, LRs, grad norms, throughput). `Timer`
fences on the card (`torch.cuda.synchronize`) before it reads the clock,
so a rate it reports is a device rate, not an enqueue rate.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Optional

import torch


class MetricLogger:
    """Append-only JSONL event log; stdout echo optional.

    The TensorBoard mirror of the JAX package is not ported:
    `tensorboard=` raises NotImplementedError."""

    def __init__(self, path: Optional[str | pathlib.Path] = None,
                 echo: bool = False,
                 tensorboard: Optional[str | pathlib.Path] = None):
        if tensorboard is not None:
            raise NotImplementedError(
                "MetricLogger(tensorboard=...) is not ported; JSONL only")
        self.path = pathlib.Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = self.path.open("a")
        else:
            self._f = None

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        line = json.dumps(rec, default=float)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()


class Timer:
    """Wall-clock timer; `stop(*tensors)` first waits for the card when
    any of the tensors lies on one."""

    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, *fence_on: Any) -> float:
        for x in fence_on:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                torch.cuda.synchronize(x.device)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed


def rate(count: float, seconds: float) -> float:
    return count / seconds if seconds > 0 else float("inf")
