"""bf16 x bf16 products with fp32 accumulation for the decoder's hidden
layers on the bf16 autograd route (`compute_dtype="bfloat16"`).

Counterpart of the bf16 branch of `WNLinear.__call__` in the JAX package's
`models/decoder.py` (:60-67), `jnp.matmul(x, w.astype(bf16),
preferred_element_type=float32) + b`: one pass of the matrix unit with
fp32 accumulation, which the reference leaves to XLA (no Pallas kernel).

    y  = x . bf16(W)^T, accumulated and returned in fp32, + b (fp32)
    dx = bf16(g) . bf16(W), rounded once to bf16 (x's type)
    dW = bf16(bf16(g)^T . x), as the gradient of the fp32 effective weight
    db = g.sum(0) in fp32

`bf16_linear_reference` is the plain version:
`F.linear(x.float(), bf16(W).float()) + b` under autograd, fp32 products
of bf16-valued tensors. A hidden layer's x and bf16(W) are bf16 by
construction, and so is its cotangent g: the layer's output is cast to
bf16 before it goes on (`models/decoder.py`), so g reaches the product as
the image of a bf16 tensor (tests/test_torch_bf16_linear.py checks all
three). Then both forms make the same products, exactly, and differ only
in the order of their fp32 sums. The 512 -> 1 head keeps the plain
form's arithmetic, not this function's: its cotangent, +-1/n or 0, is
bf16-valued only when n is a power of two and `use_tanh` is off. On the
card it runs as `ops.head`'s two kernels, elsewhere as the plain form.

On the card all three products run on the bf16 tensor cores through
cuBLAS: the forward as `torch.mm(x, bf16(W)^T, out_dtype=float32)` and an
in-place add of b (`torch.addmm` with `out_dtype` takes longer on the
H100 than the two: PERF.md), dx and dW as bf16 x bf16 -> bf16 products
(fp32 accumulation, one rounding). cuBLAS may reduce
split-K partials in bf16 unless told not to, so each product runs with
`allow_bf16_reduced_precision_reduction` off; that flag is process-wide,
so it is set around the forward's product and the backward's, and put
back in a `finally` (autograd may run the backward on a thread of its
own). No other flag is touched: every fp32 product sees TF32 as its
caller set it. On the CPU the same autograd function makes fp32 products
of the same bf16 values, the plain version's arithmetic bit for bit.
The products made on the card count in `utils.profiling.LAUNCHES` as
"bf16_linear.<role>" (fwd, dgrad, wgrad).

`bf16_linear_relu_dropout` is a hidden layer with relu + dropout through
kernels #3/#3b (`ops.relu_dropout`), as one autograd function: the
forward's fp32 product without its bias goes to #3, which adds the bias
in fp32, rounds once to bf16 and applies relu + dropout; it saves x,
bf16(W) and its own bf16 output, which the next layer saves too, and no
pre-activation. The backward's #3b masks the bf16 cotangent by that
output (out > 0) and emits it in bf16 with db, its column sums; dgrad and
wgrad take it as `bf16_linear`'s backward does. So no fp32 activation or
cotangent makes a pass of its own, and the layer equals `bf16_linear`, a
cast to bf16 and `relu_dropout` bit for bit: the output, the loss and
every gradient but db, which #3b sums in its own fixed order (on the CPU
in torch's, as `bf16_linear` does).

Both take a layout, `runs`: the logical widths of x's column runs, each
stored padded with zero columns to a multiple of 8 (`pad_columns`,
`padded_width`). cuBLAS runs a product whose rows are not 16 bytes long
on its sm75 `align1` kernels, at a fifth of what the 512-wide layers
reach on Hopper's (PERF.md). With a layout the layer pads bf16(W) to
match (zero columns at each run's pad, zero rows up to a multiple of 8
outputs) and b with zeros, so the output is padded too and its pad
columns are exactly 0: a zero product plus a zero bias, which relu and
#3/#3b keep at 0 (their Philox mask is keyed by column group, not by the
row's width, so the logical columns keep theirs). Each added term is
0 * 0: only the order of the fp32 sums may move. dW and db come back in
the parameters' logical shapes. A layout whose widths are all multiples
of 8 changes nothing. The decoder takes the layout where `pads` says so
(on the card). The products on padded operands, on either device, count
in `utils.profiling.LAUNCHES` as "bf16_linear.<role>.padded".
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch.ops import relu_dropout as rd
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling


def pads(t: torch.Tensor) -> bool:
    """Whether the bf16 hidden layers on t's device take the padded
    layout: on the card; the CPU keeps the plain version's products bit
    for bit."""
    return t.is_cuda


def padded_width(n: int) -> int:
    """n rounded up to a multiple of 8: a bf16 row of whole 16 bytes."""
    return -(-n // 8) * 8


def pad_columns(parts: list) -> torch.Tensor:
    """torch.cat(parts, -1) followed by zero columns up to a multiple of
    8: one run of the padded layout."""
    n = sum(t.shape[-1] for t in parts)
    if n % 8:
        p = parts[0]
        parts = [*parts, p.new_zeros(*p.shape[:-1], padded_width(n) - n)]
    return torch.cat(parts, dim=-1)


def logical_columns(t: torch.Tensor, runs: tuple) -> torch.Tensor:
    """The columns of t [..., stored] that hold the runs' values, without
    the zero pad after each run: t itself where no run is padded."""
    if all(r % 8 == 0 for r in runs):
        return t
    pieces, s = [], 0
    for r in runs:
        pieces.append(t[..., s:s + r])
        s += padded_width(r)
    return torch.cat(pieces, dim=-1)


def _layer_operands(w: torch.Tensor, b: torch.Tensor,
                   runs: tuple | None) -> tuple:
    """(bf16(W), fp32 b, runs) on the layout `runs` for w [out, in]: W's
    columns moved to their runs' places among zero columns, zero rows and
    zero biases up to a multiple of 8 outputs. `runs` comes back as None
    where nothing is padded: then bf16(W) and b as they are."""
    out = w.shape[0]
    if runs is not None and sum(runs) != w.shape[1]:
        raise ValueError(f"layout {runs} for a weight of {w.shape[1]} "
                         "inputs")
    if runs is None or (out % 8 == 0 and all(r % 8 == 0 for r in runs)):
        return w.to(torch.bfloat16), b.float(), None
    wb = w.new_zeros(padded_width(out), sum(map(padded_width, runs)),
                     dtype=torch.bfloat16)
    c = s = 0
    for r in runs:
        wb[:out, s:s + r] = w[:, c:c + r]
        c, s = c + r, s + padded_width(r)
    return wb, F.pad(b.float(), (0, wb.shape[0] - out)), runs


def bf16_linear_reference(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 products of x (bf16) and bf16(w), plus the fp32
    bias; differentiable by autograd."""
    return F.linear(x.float(), w.to(torch.bfloat16).float()) + b.float()


def bf16_linear_relu_dropout_reference(x: torch.Tensor, w: torch.Tensor,
                                       b: torch.Tensor, seed: int,
                                       rate: float, runs: tuple | None = None,
                                       linear=None) -> torch.Tensor:
    """The composition `bf16_linear_relu_dropout` equals: the product with
    its fp32 bias, the cast to bf16, then `relu_dropout` (kernels #3/#3b
    on the card, their plain versions on the CPU). `linear`, when given,
    is another product form (x, w, b) -> fp32 on the unpadded layout (the
    plain version, a float64 witness) in place of `bf16_linear`."""
    y = bf16_linear(x, w, b, runs) if linear is None else linear(x, w, b)
    return rd.relu_dropout(y.to(torch.bfloat16), seed, rate)


@contextlib.contextmanager
def _tensor_core_flags() -> Iterator[None]:
    """cuBLAS keeps bf16 products' partial sums in fp32 inside the block;
    the flag (and its split-K half, kept as the caller set it) is put back
    as it was, also when the block raises."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_bf16_reduced_precision_reduction,
             m.allow_bf16_reduced_precision_reduction_split_k)
    try:
        m.allow_bf16_reduced_precision_reduction = (False, saved[1])
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = saved


def _count(role: str, a: torch.Tensor, padded: bool) -> None:
    if a.is_cuda:
        profiling.launched(f"bf16_linear.{role}")
    if padded:
        profiling.launched(f"bf16_linear.{role}.padded")


def _product(a: torch.Tensor, b: torch.Tensor, role: str,
             padded: bool) -> torch.Tensor:
    """a @ b of bf16 operands, accumulated in fp32 and rounded once to
    bf16: on the card on the tensor cores (inside `_tensor_core_flags`),
    on the CPU as the fp32 product of the same values."""
    _count(role, a, padded)
    if a.device.type == "cpu":
        return torch.mm(a.float(), b.float()).to(torch.bfloat16)
    return torch.mm(a, b)


def _forward_product(x2: torch.Tensor, wb: torch.Tensor,
                     runs: tuple | None) -> torch.Tensor:
    """x2 . wb^T accumulated and returned in fp32, without the bias."""
    _count("fwd", x2, runs is not None)
    if x2.is_cuda:
        with _tensor_core_flags():
            return torch.mm(x2, wb.t(), out_dtype=torch.float32)
    return torch.mm(x2.float(), wb.t().float())


def _backward_products(ctx, gb: torch.Tensor, x2: torch.Tensor,
                       wb: torch.Tensor) -> tuple:
    """(dx, dW) from the bf16 cotangent gb, each where autograd asks; dW
    in the weight's logical shape."""
    dx = dw = None
    padded = ctx.runs is not None
    with (_tensor_core_flags() if gb.is_cuda
          else contextlib.nullcontext()):
        if ctx.needs_input_grad[0]:
            dx = _product(gb, wb, "dgrad", padded).reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = _product(gb.t(), x2, "wgrad", padded)
            if padded:
                dw = logical_columns(dw[:ctx.out], ctx.runs)
            dw = dw.float()
    return dx, dw


class _Bf16Linear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, runs):
        x2 = x.reshape(-1, x.shape[-1])
        wb, bf, ctx.runs = _layer_operands(w, b, runs)
        ctx.save_for_backward(x2, wb)
        ctx.x_shape, ctx.out = x.shape, w.shape[0]
        y = _forward_product(x2, wb, ctx.runs)
        y.add_(bf)
        return y.reshape(*x.shape[:-1], wb.shape[0])

    @staticmethod
    def backward(ctx, g):
        x2, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx, dw = _backward_products(ctx, g2.to(torch.bfloat16), x2, wb)
        db = g2.sum(0)[:ctx.out] if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


class _Bf16ReluDropoutLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, seed, rate, runs):
        x2 = x.reshape(-1, x.shape[-1])
        wb, bf, ctx.runs = _layer_operands(w, b, runs)
        out = rd.bias_relu_dropout_fwd(_forward_product(x2, wb, ctx.runs),
                                       bf, seed, rate)
        out = out.reshape(*x.shape[:-1], wb.shape[0])
        ctx.save_for_backward(x2, wb, out)
        ctx.x_shape, ctx.out, ctx.rate = x.shape, w.shape[0], rate
        return out

    @staticmethod
    def backward(ctx, g):
        x2, wb, out = ctx.saved_tensors
        # a skip layer's cat hands on a column slice: #3b takes a copy
        gb, db = rd.relu_dropout_bwd_out(
            out.reshape(-1, out.shape[-1]),
            g.reshape(-1, g.shape[-1]).to(torch.bfloat16).contiguous(),
            ctx.rate)
        dx, dw = _backward_products(ctx, gb, x2, wb)
        db = db[:ctx.out] if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


def bf16_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                runs: tuple | None = None) -> torch.Tensor:
    """x [..., in] bf16, w [out, in] and b [out] fp32 -> [..., out] fp32:
    x . bf16(w)^T with fp32 accumulation, plus b (the reference's bf16
    branch). Differentiable in all three; on the card every product runs
    on the bf16 tensor cores, on the CPU as the plain version's. With a
    layout `runs` (the module docstring), x and the output are padded:
    [..., stored] -> [..., padded_width(out)]."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"bf16_linear: x is {x.dtype}, not bfloat16")
    return _Bf16Linear.apply(x, w, b, runs)


def bf16_linear_relu_dropout(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, seed: int, rate: float,
                             runs: tuple | None = None) -> torch.Tensor:
    """A bf16 hidden layer with relu + dropout: x [..., in] bf16, w [out,
    in] and b [out] fp32 -> [..., out] bf16, equal to
    relu_dropout(bf16_linear(x, w, b).to(bfloat16), seed, rate). On the
    card the product runs on the tensor cores and kernel #3 adds b,
    rounds and drops; the backward runs #3b from the output, then dgrad
    and wgrad. On the CPU the plain versions, as the composition runs.
    `runs` as for bf16_linear."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"bf16_linear_relu_dropout: x is {x.dtype}, not "
                         "bfloat16")
    return _Bf16ReluDropoutLinear.apply(x, w, b, int(seed), float(rate),
                                        runs)
