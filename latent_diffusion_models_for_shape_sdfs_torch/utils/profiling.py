"""Tracing, cost analysis and the NaN checker.

Counterpart of the JAX package's `utils/profiling.py`:

- ``trace(logdir, device="cuda")``: `torch.profiler` over a window of
  work, written as a Chrome/TensorBoard trace (`*.pt.trace.json`).
- ``cost_analysis(fn, *args)``: the FLOPs and bytes of one call of `fn`,
  under the key names of XLA's cost analysis ("flops", "bytes accessed").
- ``debug_nans()``: the first op that writes a NaN raises
  FloatingPointError naming the op, as `jax_debug_nans` does.

Both modes see every aten op (a `TorchDispatchMode` sits below autograd,
so ops under `no_grad` and in backward are seen too) and the op
`sdfldm::fused_eval` (kernel #1). The port's other kernels are ctypes
launches that never reach the dispatcher; their wrappers report each
launch through two hooks that do nothing outside the modes:
`check_kernel(name, *tensors)` (the NaN check of its inputs and outputs)
and `count_kernel(name, flops, nbytes)` (its work); `kernel_pass` counts
a pass of several launches once. A kernel reports the FLOPs its plain
version's aten ops count (`torch.utils.flop_counter`'s formulas) and the
bytes its bound counts: each input read once, each output written once.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import torch
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
    """Hook of a kernel launched outside the dispatcher: under
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


def count_kernel(name: str, flops: float, nbytes: float) -> None:
    """Hook of a kernel launched outside the dispatcher: under
    `cost_analysis`, add the launch's FLOPs and bytes (`name` says whose);
    elsewhere nothing."""
    mode = _active(_CostMode)
    if mode is not None:
        mode.add(flops, nbytes)


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


# ------------------------------------------------------------------ trace


@contextlib.contextmanager
def trace(logdir: str, device="cuda") -> Iterator[None]:
    """torch.profiler over the block (CPU and CUDA activity; CPU only with
    device="cpu"), written under `logdir` as a Chrome/TensorBoard trace
    `<host>_<pid>.<time>.pt.trace.json` when the block ends. Raises
    RuntimeError for device="cuda" without a card."""
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
