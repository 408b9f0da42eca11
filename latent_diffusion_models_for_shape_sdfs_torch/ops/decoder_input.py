"""The bf16 decoder's input and skip operands written from per-scene codes:
`csrc/decoder_input.cu`'s kernels as two autograd functions.

A training step gives each of its S scenes one code z [S, L] and P points
xyz [S, P, 3]. The decoder's padded bf16 layout (`ops.bf16_linear`) feeds
lin0 the rows [bf16(z[s]) | bf16(xyz[s, p]) | 0] and the skip layer the
rows [x | bf16(z[s]) | bf16(xyz[s, p]) | 0], x the layer before's output.
Built the plain way, the codes first become a flat [S P, L] fp32 tensor,
then its bf16 cast, then two concatenations; in the backward the two
cotangents of lin0's input are added in bf16 and summed over each
scene's rows. Here neither precision of the flat codes exists:

    decoder_input(z, xyz)    -> [S P, T] bf16, T = L + 3 rounded up to 8,
                                bit for bit pad_columns([bf16(z) over each
                                scene's rows, bf16(xyz)]);
        backward: dz[s] = sum_p fp32(d[p, :L]) over scene s's rows
    skip_input(x, z, xyz)    -> [S P, W + T] bf16, bit for bit
                                torch.cat([x, decoder_input(z, xyz)], -1),
                                x [S P, W] bf16 with W % 8 == 0;
        backward: dx = d[:, :W] as a dense tensor (the layer before's
                  cotangent, which it takes as it is), dz[s] = sum_p
                  fp32(d[p, W:W + L])

Each of the two functions makes its own dz, and autograd adds the two
[S, L] results in fp32. So the forward, the loss and every weight
gradient stay bit for bit what the plain form gives, and the codes'
gradient drops one rounding: sum_p fp32(bf16(a_p + b_p)) becomes sum_p
a_p + sum_p b_p in fp32, which the benchmark's fp32-backward reference
makes too; only the order of the fp32 sums differs from it.

xyz carries no gradient here: both functions raise where it asks for
one. The kernels run on the card alone: the functions take fp32 z, and
xyz fp32 or bf16 (a bf16 value is exact in fp32), on one CUDA device,
and raise on anything else; a row wider than the kernels take fails at
its launch. Each forward and backward reports once to
`utils.profiling`'s record as "decoder_input.fwd", "decoder_input.bwd",
"skip_input.fwd" and "skip_input.bwd". The decoder (`models/decoder.py`)
calls them on the card's padded route and otherwise expands z itself.
"""

from __future__ import annotations

import ctypes

import torch

from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
from latent_diffusion_models_for_shape_sdfs_torch.ops.bf16_linear import (
    padded_width)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

# csrc/decoder_input.cu's work item (checked against the kernels at load):
# the backward's rows a partial row of column sums
_ITEM_ROWS = 128

BF = torch.bfloat16


def _lib():
    lib = _build.load("decoder_input.cu")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.input_rows_launch.restype = i32
        lib.input_rows_launch.argtypes = [vp, i32, vp, vp, vp, i64, i64, i32,
                                          vp]
        lib.scene_colsum_launch.restype = i32
        lib.scene_colsum_launch.argtypes = [vp, i32, i32, vp, vp, vp, i64,
                                            i64, i32, vp]
        got = (ctypes.c_int * 1)()
        lib.decoder_input_constants(got)
        if got[0] != _ITEM_ROWS:
            raise RuntimeError(f"decoder_input.cu's work item of {got[0]} "
                               f"rows differs from the wrapper's "
                               f"{_ITEM_ROWS}")
        lib._argtypes_set = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows(name: str, x, z: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """[x | bf16(z[s]) | bf16(xyz) | 0] ([S P, W + T] bf16; no x where it
    is None)."""
    S, P, L = xyz.shape[0], xyz.shape[1], z.shape[1]
    xw = 0 if x is None else x.shape[1]
    out = torch.empty(S * P, xw + padded_width(L + 3), dtype=BF,
                      device=z.device)
    rc = _lib().input_rows_launch(
        None if x is None else x.data_ptr(), xw, z.data_ptr(),
        xyz.data_ptr(), out.data_ptr(), S, P, L, _stream(z))
    read = [t for t in (x, z, xyz) if t is not None]
    profiling.launched(name, rc, *read, out,
                       nbytes=sum(t.nbytes for t in read) + out.nbytes)
    return out


def _colsum(name: str, d: torch.Tensor, xw: int, S: int, P: int,
            L: int) -> tuple:
    """(dx = d[:, :xw] dense, or None where xw == 0; dz [S, L] fp32 =
    sum over each scene's rows of fp32(d[:, xw:xw + L]))."""
    d = d.contiguous()
    dx = torch.empty(S * P, xw, dtype=BF, device=d.device) if xw else None
    dz = torch.empty(S, L, dtype=torch.float32, device=d.device)
    items = S * -(-P // _ITEM_ROWS)
    partials = torch.empty(items, L, dtype=torch.float32, device=d.device)
    rc = _lib().scene_colsum_launch(
        d.data_ptr(), d.shape[1], xw, None if dx is None else dx.data_ptr(),
        partials.data_ptr(), dz.data_ptr(), S, P, L, _stream(d))
    wrote = [t for t in (dx, dz) if t is not None]
    profiling.launched(name, rc, d, *wrote,
                       nbytes=S * P * (xw + L) * 2
                       + sum(t.nbytes for t in wrote))
    return dx, dz


class _DecoderInput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, xyz):
        ctx.shape = (xyz.shape[0], xyz.shape[1], z.shape[1])
        return _rows("decoder_input.fwd", None, z, xyz)

    @staticmethod
    def backward(ctx, d):
        if not ctx.needs_input_grad[0]:
            return None, None
        _, dz = _colsum("decoder_input.bwd", d, 0, *ctx.shape)
        return dz, None


class _SkipInput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, z, xyz):
        ctx.shape = (xyz.shape[0], xyz.shape[1], z.shape[1])
        ctx.xw = x.shape[1]
        return _rows("skip_input.fwd", x, z, xyz)

    @staticmethod
    def backward(ctx, d):
        if not any(ctx.needs_input_grad[:2]):
            return None, None, None
        dx, dz = _colsum("skip_input.bwd", d, ctx.xw, *ctx.shape)
        return (dx if ctx.needs_input_grad[0] else None,
                dz if ctx.needs_input_grad[1] else None, None)


def _check(name: str, z: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """xyz as the kernels read it (fp32); raises on what they cannot
    take."""
    if z.dim() != 2 or xyz.dim() != 3 or xyz.shape[0] != z.shape[0] \
            or xyz.shape[2] != 3:
        raise ValueError(f"{name}: z {tuple(z.shape)}, xyz "
                         f"{tuple(xyz.shape)}; wants [S, L] and [S, P, 3]")
    if xyz.requires_grad:
        raise ValueError(f"{name}: xyz asks for a gradient; the functions "
                         "make none")
    if not (z.is_cuda and xyz.device == z.device and z.dtype == torch.float32
            and xyz.dtype in (torch.float32, BF)):
        raise ValueError(f"{name}: the kernels take fp32 z and fp32 or bf16 "
                         f"xyz on one card; got z {z.dtype} on {z.device}, "
                         f"xyz {xyz.dtype} on {xyz.device}")
    return xyz.float()


def decoder_input(z: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """lin0's input on the padded layout from z [S, L] and xyz [S, P, 3]:
    [S P, T] bf16, differentiable in z (the module docstring)."""
    xyz = _check("decoder_input", z, xyz)
    return _DecoderInput.apply(z.contiguous(), xyz.contiguous())


def skip_input(x: torch.Tensor, z: torch.Tensor,
               xyz: torch.Tensor) -> torch.Tensor:
    """The skip layer's input [x | decoder_input(z, xyz)] for x [S P, W]
    bf16, W % 8 == 0: [S P, W + T] bf16, differentiable in x and z."""
    xyz = _check("skip_input", z, xyz)
    rows = xyz.shape[0] * xyz.shape[1]
    if x.dtype != BF or x.dim() != 2 or x.shape[0] != rows \
            or x.shape[1] % 8 or x.device != z.device:
        raise ValueError(f"skip_input: x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}; wants [{rows}, W] bfloat16, W % 8 "
                         f"== 0, on {z.device}")
    return _SkipInput.apply(x.contiguous(), z.contiguous(),
                            xyz.contiguous())
