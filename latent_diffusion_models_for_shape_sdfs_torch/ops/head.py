"""The bf16 decoder's scalar head (its last linear layer, C -> 1) on the
card: `csrc/head.cu`'s two kernels as one autograd function.

The head's plain form is `ops.bf16_linear.bf16_linear_reference`,
`F.linear(x.float(), bf16(W).float()) + b` under autograd, which
`WNLinear` runs for a bf16 input. Its cotangent, +-1/n or 0, is not
bf16-valued in general, so the head cannot take `bf16_linear`'s bf16
backward products; these kernels keep its arithmetic instead:

    pred = x . bf16(W)^T + b                 fp32 sums of exact products
    dx   = bf16(g . bf16(W))                 the fp32 product, rounded once
    dW   = fp32(bf16(g^T . x))               the cast's backward, as before
    db   = g.sum()

Only the order of the fp32 sums moves (pred's C terms, dW's and db's
rows). The forward saves x, which the layer before saves as its own
output, and bf16(W): no fp32 copy of x. The backward reads g and x once
and writes dx once; each of dx, dW and db is made only where autograd
asks for it (a reconstruction asks for dx alone, and then x is not read).

The decoder (`models/decoder.py`) sends every bf16 head input here, on
either device. On a CPU tensor `bf16_head` runs the plain form's
arithmetic bit for bit (the same torch products, sums and casts autograd
runs for it). On a CUDA tensor it launches the kernels, which take rows
of whole 16 bytes (C % 8 == 0) of at most `MAX_COLS` columns (`takes`),
and raises on any other. Each launch reports to `utils.profiling`'s
record (`launched`) as "head_fwd" or "head_bwd": the plain form's FLOPs
(`torch.utils.flop_counter`'s for its products), the bytes its bound
counts, and the NaN check of what it reads and writes.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

# csrc/head.cu's constants (checked against the kernels at load)
_BWD_ROWS = 64          # backward: rows a tile
MAX_COLS = 2048         # the widest row the kernels take
_BWD_CTAS = 4 * 132     # the backward's fixed grid: 4 CTAs on each SM

BF = torch.bfloat16


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take the head input x [..., C]."""
    return (x.is_cuda and x.dtype == BF and x.shape[-1] % 8 == 0
            and 0 < x.shape[-1] <= MAX_COLS)


def _lib():
    lib = _build.load("head.cu")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.head_fwd_launch.restype = i32
        lib.head_fwd_launch.argtypes = [vp, vp, vp, vp, ctypes.c_longlong,
                                        i32, vp]
        lib.head_bwd_launch.restype = i32
        lib.head_bwd_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                        ctypes.c_longlong, i32, i32, vp]
        got = (ctypes.c_int * 2)()
        lib.head_constants(got)
        want = (_BWD_ROWS, MAX_COLS)
        if tuple(got) != want:
            raise RuntimeError(f"head.cu's constants {tuple(got)} differ "
                               f"from the wrapper's {want}")
        lib._argtypes_set = True
    return lib


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t itself if contiguous and on 16 bytes, else a dense copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _forward(x2: torch.Tensor, wb: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """pred [rows, 1] fp32 of x2 [rows, C] bf16, wb [1, C] bf16, b [1]."""
    if x2.device.type == "cpu":
        return F.linear(x2.float(), wb.float()) + b
    rows, cols = x2.shape
    pred = torch.empty(rows, 1, dtype=torch.float32, device=x2.device)
    if rows == 0:
        return pred
    rc = _lib().head_fwd_launch(
        x2.data_ptr(), wb.data_ptr(), b.data_ptr(), pred.data_ptr(), rows,
        cols, torch.cuda.current_stream(x2.device).cuda_stream)
    profiling.launched("head_fwd", rc, x2, wb, b, pred,
                       flops=2 * rows * cols,
                       nbytes=x2.nbytes + wb.nbytes + b.nbytes + pred.nbytes)
    return pred


def _backward(g: torch.Tensor, x2: torch.Tensor, wb: torch.Tensor,
              b_shape, needs: tuple) -> tuple:
    """(dx [rows, C] bf16, dW [1, C] fp32, db fp32 of b's shape) from the
    cotangent g [..., 1], each None where `needs` does not ask for it."""
    rows, cols = x2.shape
    if x2.device.type == "cpu":
        g2 = g.reshape(-1, 1)
        dx = torch.mm(g2, wb.float()).to(BF) if needs[0] else None
        dw = (torch.mm(g2.t(), x2.float()).to(BF).float() if needs[1]
              else None)
        db = g.sum_to_size(b_shape) if needs[2] else None
        return dx, dw, db
    dev = x2.device
    dx = torch.empty_like(x2) if needs[0] else None
    dw = torch.empty(1, cols, dtype=torch.float32, device=dev) \
        if needs[1] else None
    db = torch.empty(b_shape, dtype=torch.float32, device=dev) \
        if needs[2] else None
    if rows == 0:
        for t in (dw, db):
            if t is not None:
                t.zero_()
        return dx, dw, db
    g1 = _dense(g.reshape(-1).float())
    ctas = min(-(-rows // _BWD_ROWS), _BWD_CTAS)
    partials = torch.empty(ctas, cols + 1, dtype=torch.float32, device=dev)
    rc = _lib().head_bwd_launch(
        g1.data_ptr(), x2.data_ptr() if needs[1] else None, wb.data_ptr(),
        _ptr(dx), partials.data_ptr(), _ptr(dw), _ptr(db), rows, cols, ctas,
        torch.cuda.current_stream(dev).cuda_stream)
    outs = [t for t in (dx, dw, db) if t is not None]
    profiling.launched(
        "head_bwd", rc, g1, x2, wb, *outs,
        flops=2 * rows * cols * (int(needs[0]) + int(needs[1])),
        nbytes=g1.nbytes + (x2.nbytes if needs[1] else 0) + wb.nbytes
        + sum(t.nbytes for t in outs))
    return dx, dw, db


class _Head(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b):
        x2 = x.reshape(-1, x.shape[-1])
        if x2.is_cuda:
            x2 = _dense(x2)
        wb = w.to(BF).contiguous()
        ctx.save_for_backward(x2, wb)
        ctx.x_shape, ctx.b_shape = x.shape, b.shape
        return _forward(x2, wb, b).reshape(*x.shape[:-1], 1)

    @staticmethod
    def backward(ctx, g):
        x2, wb = ctx.saved_tensors
        dx, dw, db = _backward(g, x2, wb, ctx.b_shape,
                               ctx.needs_input_grad)
        return (None if dx is None else dx.reshape(ctx.x_shape)), dw, db


def bf16_head(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The head: x [..., C] bf16, w [1, C] and b [1] fp32 -> [..., 1] fp32,
    x . bf16(w)^T with fp32 sums, plus b; differentiable in all three. On
    the card the two kernels (rows that `takes`, else ValueError), on the
    CPU the plain form's arithmetic bit for bit."""
    if x.dtype != BF:
        raise ValueError(f"bf16_head: x is {x.dtype}, not bfloat16")
    if w.shape != (1, x.shape[-1]) or b.shape != (1,) \
            or w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"bf16_head: w {tuple(w.shape)} {w.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype} for x "
                         f"{tuple(x.shape)}; wants fp32 [1, C] and [1]")
    if x.device.type not in ("cpu", "cuda") or w.device != x.device \
            or b.device != x.device:
        raise ValueError(f"bf16_head: x on {x.device}, w on {w.device}, b "
                         f"on {b.device}")
    if x.is_cuda and not takes(x):
        raise ValueError(f"bf16_head: rows of {x.shape[-1]} columns; the "
                         f"kernels take multiples of 8 up to {MAX_COLS}")
    return _Head.apply(x, w, b)
