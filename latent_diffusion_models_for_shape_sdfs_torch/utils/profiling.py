"""Tracing, spans, cost analysis, the NaN checker and the launch record.

Counterpart of the JAX package's `utils/profiling.py`:

- ``trace(logdir, device="cuda")``: `torch.profiler` over a window of
  work, written as a Chrome/TensorBoard trace (`*.pt.trace.json`).
- ``span(name)``: a named phase of a training step. Off (no profiler
  running) it is one shared no-op; on, a host range in the profiler's
  trace, a pair of CUDA events on the current stream, and a record that
  ``span_records(name)`` reads back as host and device seconds.
- ``cost_analysis(fn, *args)``: the FLOPs and bytes of one call of `fn`,
  under the key names of XLA's cost analysis ("flops", "bytes accessed").
- ``debug_nans()``: the first op that writes a NaN raises
  FloatingPointError naming the op, as `jax_debug_nans` does.
- ``LAUNCHES``: the port's one launch record, a per-process
  `collections.Counter` by launch name (`ops.bf16_linear` counts its
  cuBLAS products there too, as "bf16_linear.<role>[.padded]").

Both modes see every aten op (a `TorchDispatchMode` sits below autograd,
so ops under `no_grad` and in backward are seen too) and the op
`sdfldm::fused_eval` (kernel #1). The port's kernels are ctypes launches
that never reach the dispatcher; each wrapper reports each launch in one
call, `launched(name, rc, *tensors, flops=, nbytes=)`, which checks the
return code, counts the launch and, inside the modes, NaN-checks
`tensors` and adds the launch's work (kernel #1's wrapper only counts);
`kernel_pass` counts a pass of several launches once. A kernel reports
the FLOPs its plain version's aten ops count (`torch.utils.flop_counter`'s
formulas) and the bytes its bound counts: each input read once, each
output written once.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Callable, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
    _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
# ops whose output is allocated but not written: its bytes are whatever
# the allocator left there, so neither mode reads them
_UNWRITTEN = {aten.empty, aten.empty_like, aten.empty_strided,
              aten.new_empty, aten.new_empty_strided, aten.resize_}
# namespaces of the port's kernels as ops: checked on their inputs too
_KERNELS = ("sdfldm",)


def _writes(func) -> bool:
    """Whether the op writes an output: views and allocations do not."""
    return not func.is_view and func._overloadpacket not in _UNWRITTEN


def _floating(tensors) -> list:
    return [t for t in tensors if isinstance(t, torch.Tensor)
            and t.is_floating_point() and t.layout == torch.strided
            and t.device.type != "meta" and t.numel()]


def _active(kind: type):
    """The innermost mode of `kind` on this thread's dispatch stack."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, kind):
            return mode
    return None


# ------------------------------------------------------------ NaN checker


class _NanMode(TorchDispatchMode):

    @staticmethod
    def check(name: str, tensors) -> None:
        with _disable_current_modes():
            flags = [torch.isnan(t).any() for t in _floating(tensors)]
            if any(bool(f) for f in flags):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {name}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in _KERNELS:
            self.check(str(func), tree_flatten((args, kwargs))[0])
        out = func(*args, **kwargs)
        if _writes(func):
            self.check(str(func), tree_flatten(out)[0])
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Under this context the first op that writes a NaN into a floating
    output raises FloatingPointError("invalid value (nan) encountered in
    <op>"): every aten op (forward, backward, under `no_grad`), checked on
    what it writes; the port's kernels, checked on what they read and
    write. A kernel's clamp or relu (a compare, `fminf`) can turn a NaN
    into a number, so a NaN that reaches one from outside the context (a
    label, a weight) is caught at the kernel, as the reference's checker
    catches it at the first op that reads it. Every check waits for the
    device. A CUDA graph cannot be checked op by op: capturing one under
    this context raises (`train.graph.capture_step`).

    The checker reads outputs only, so the results are the same bits with
    and without it. `enable=False` adds no check (the CLI's flag is passed
    here)."""
    if not enable:
        yield
        return
    with _NanMode():
        yield


def nans_checked() -> bool:
    """Whether this thread runs under `debug_nans`."""
    return _active(_NanMode) is not None


def check_kernel(name: str, *tensors: Any) -> None:
    """NaN hook of a kernel launched outside the dispatcher: under
    `debug_nans`, raise FloatingPointError naming the kernel if a floating
    tensor among `tensors` holds a NaN; elsewhere nothing."""
    if _active(_NanMode) is not None:
        _NanMode.check(name, tensors)


# ---------------------------------------------------------- cost analysis


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor) and t.layout == torch.strided)


class _CostMode(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.quiet = 0          # inside a kernel pass: counted already

    def add(self, flops: float, nbytes: float) -> None:
        if not self.quiet:
            self.flops += flops
            self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _writes(func):
            formula = flop_registry.get(func._overloadpacket)
            self.add(formula(*args, **kwargs, out_val=out) if formula else 0,
                     _nbytes(tree_flatten((args, kwargs))[0])
                     + _nbytes(tree_flatten(out)[0]))
        return out


@contextlib.contextmanager
def kernel_pass(name: str, flops: float, nbytes: float) -> Iterator[None]:
    """A pass of several launches (kernel #4) counted once as one kernel:
    under `cost_analysis` its FLOPs and bytes are added, and nothing
    launched or dispatched inside is counted again."""
    mode = _active(_CostMode)
    if mode is None:
        yield
        return
    mode.add(flops, nbytes)
    mode.quiet += 1
    try:
        yield
    finally:
        mode.quiet -= 1


def cost_analysis(fn: Callable, *args: Any, **kwargs: Any) -> dict:
    """{"flops", "bytes accessed"} of one call fn(*args, **kwargs).

    Unlike the reference's (`jax.jit(fn).lower().compile()`'s estimate),
    this executes `fn` once, under a dispatch mode that counts every op
    it dispatches and every kernel launch its wrappers report. FLOPs are
    those of `torch.utils.flop_counter`'s formulas (matrix products,
    convolutions, attention: elementwise ops count none, where XLA counts
    them too), and a kernel's are its plain version's. Bytes are an upper
    estimate: every input and output of every op, read or written once
    per op (views and allocations count none), so a tensor that several
    ops read counts several times; a kernel counts its bound's bytes."""
    mode = _CostMode()
    with mode:
        fn(*args, **kwargs)
    return {"flops": float(mode.flops), "bytes accessed": float(mode.bytes)}


# ------------------------------------------------------------- launches

LAUNCHES: collections.Counter = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()     # autograd may launch on its own thread


def launched(name: str, rc: int = 0, *tensors: Any, flops: float = 0,
             nbytes: float = 0) -> None:
    """The record of one launch outside the dispatcher, made by its
    wrapper right after it with the launcher's return code: a non-zero
    `rc` raises RuntimeError naming the launch and counts nothing; else
    LAUNCHES[name] gains one, `tensors` (what the launch read and wrote)
    are NaN-checked (`check_kernel`) and, under `cost_analysis`, `flops`
    and `nbytes` added unless a `kernel_pass` counted them already."""
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed, cudaError {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
    check_kernel(name, *tensors)
    mode = _active(_CostMode)
    if mode is not None:
        mode.add(flops, nbytes)


# ------------------------------------------------------------------ trace


@contextlib.contextmanager
def trace(logdir: str, device="cuda") -> Iterator[None]:
    """torch.profiler over the block (CPU and CUDA activity; CPU only with
    device="cpu"), written under `logdir` as a Chrome/TensorBoard trace
    `<host>_<pid>.<time>.pt.trace.json` when the block ends; the spans
    (`span`) run inside are host ranges in it, and `span_records` reads
    their times after it. Raises RuntimeError for device="cuda" without a
    card."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace(device='cuda'): no CUDA device is "
                               "available; pass device='cpu' to trace the "
                               "CPU")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


# ------------------------------------------------------------------ spans

# records kept, every thread's together: the newest SPAN_RECORDS spans
SPAN_RECORDS = 4096
_SPANS: collections.deque = collections.deque(maxlen=SPAN_RECORDS)
_SPANS_LOCK = threading.Lock()
# the span while no profiler runs: one shared object that does nothing
_NO_SPAN = contextlib.nullcontext()


def _stream_event() -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current CUDA stream, or None
    without an initialised card or while the stream captures a graph."""
    if not torch.cuda.is_initialized() \
            or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:

    __slots__ = ("name", "_range", "_t0", "_ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._ev0 = _stream_event()
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        ev1 = _stream_event() if self._ev0 is not None else None
        self._range.__exit__(*exc)
        with _SPANS_LOCK:
            _SPANS.append((self.name, self._t0, t1,
                           self._ev0 if ev1 is not None else None, ev1))
        return False


def span(name: str):
    """A named phase of the work, as a context manager.

    Off, while no torch profiler runs (`trace`, or any
    `torch.profiler.profile`), it returns one shared no-op: no
    allocation, no CUDA call, no record. On, it is
    `torch.profiler.record_function(name)`, a host range in the trace
    under which the ops and kernels launched inside nest (only on threads
    the profiler follows: the one that started it and autograd's), and,
    on an initialised card whose current stream is not capturing a CUDA
    graph, a pair of timing events recorded on that stream at entry and
    exit: the span's extent on the device's clock. Each span, on any
    thread, is kept as a record (the newest SPAN_RECORDS) that
    `span_records` reads. Names starting with "bench." are the
    benchmark's own."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def span_records(name: str, last: Optional[int] = None) -> list:
    """[(host_s, device_s)] of the kept spans named `name`, oldest first,
    the newest `last` of them (all with None). `device_s` waits for the
    span's end event and is None where no events were recorded (no card,
    or a stream capturing a graph)."""
    with _SPANS_LOCK:
        recs = [r for r in _SPANS if r[0] == name]
    if last is not None:
        recs = recs[max(0, len(recs) - last):]
    out = []
    for _, t0, t1, ev0, ev1 in recs:
        device_s = None
        if ev1 is not None:
            ev1.synchronize()
            device_s = ev0.elapsed_time(ev1) / 1e3
        out.append(((t1 - t0) / 1e9, device_s))
    return out
