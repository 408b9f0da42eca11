"""Kernel #1 (`csrc/fused_eval.cu`) as the custom op `sdfldm::fused_eval`.

    fused_eval(xyz [N,3] f32, w bf16, rows [R] f32, meta int64 [layers, 5]
               on the CPU, use_tanh) -> sdf [N] f32

`w`, `rows` and `meta` are the packed decoder of
`ops.cuda_kernels.pack_weights` / `hoisted_rows`. On CUDA tensors the op
launches the kernel (through its plain C interface, with ctypes) on the
current stream, or raises: it never falls back. The launcher reads the
layer table `meta` from host memory, so `meta` always lies on the CPU. On
CPU tensors it runs `packed_plain`, the plain version of the same
function on the packed operands (bf16 operands, fp32 products and sums,
the arithmetic of `ops.fused_decoder.fast_apply`). Its fake
implementation gives `torch.export` the output's shape, so a program
that evaluates the decoder through `ops.cuda_kernels.KernelApply` traces
to a graph holding this op, and the packed weights become the program's
constants.

Each launch is recorded here, where the kernel is launched, so launches
from an exported program count too (`utils.profiling.launched`, which
only counts it: the op's FLOPs, `eval_flops`, are registered with
`torch.utils.flop_counter` for `cost_analysis` and a `FlopCounterMode`,
and `debug_nans` checks the op's inputs and outputs).

This module imports nothing of `models/`: importing it is all a process
needs to run a `torch.export` program that calls the op (the serving
artifacts of `export_artifact`).
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F
from torch.utils.flop_counter import register_flop_formula

from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

MAX_WIDTH = 512    # both eval kernels' MAX_WIDTH (checked at load)
MAX_LAYERS = 16    # both eval kernels' MAX_LAYERS
MAX_LATENT = 512   # csrc/fused_eval_pairs.cu MAX_LATENT (checked at load)
EVAL_WIDTHS = (64, 128, 256, 512)    # both eval kernels' padded widths
# csrc/fused_eval_pairs.cu's shared-memory layout (checked at load): bytes
# of a ring slot (one slab), the byte strides between 8x8 core matrices of
# a weight slab and of an activation or latent tile (wgmma's K-major layout
# without swizzle), next 8 inputs (LBO) and next 8 rows (SBO), and the
# slabs per ring stage (every layer's slab count is a multiple of it)
PAIRS_LAYOUT = dict(slot_bytes=16384, slab_lbo=128, slab_sbo=256,
                    tile_lbo=1024, tile_sbo=128, stage_slabs=2)
# csrc/fused_eval.cu's (checked at load): the same, and the width of its
# xyz tile (bf16 x, y, z, then zeros), the inputs of an xyz slab
EVAL_LAYOUT = dict(PAIRS_LAYOUT, xyz_cols=16)


def _fused_eval_lib():
    lib = _build.load("fused_eval.cu")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.fused_eval_launch.restype = i32
        lib.fused_eval_launch.argtypes = [
            vp, vp, i64, vp, vp, ctypes.POINTER(i64), i32, i32, vp]
        lib.fused_eval_config.restype = i32
        lib.fused_eval_config.argtypes = [ip, ip, ip, ip]
        lib.fused_eval_layout.restype = None
        lib.fused_eval_layout.argtypes = [ip]
        lib.fused_eval_max_width.restype = i32
        lib.fused_eval_max_width.argtypes = []
        layout = (ctypes.c_int * len(EVAL_LAYOUT))()
        lib.fused_eval_layout(layout)
        if (lib.fused_eval_max_width() != MAX_WIDTH
                or list(layout) != list(EVAL_LAYOUT.values())):
            raise RuntimeError("csrc/fused_eval.cu and cuda_kernels.py "
                               "disagree on the widest layer or on the "
                               "shared-memory layout")
        lib._argtypes_set = True
    return lib


def check_operands(xyz: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
                   meta: torch.Tensor) -> None:
    """Raise ValueError unless the operands are what the kernel reads: xyz
    a contiguous f32 [N, 3] tensor; meta a contiguous CPU int64 [layers,
    5] table; rows a contiguous f32 vector of the table's total width and
    w a contiguous bf16 vector, both on xyz's device."""
    if (xyz.dtype != torch.float32 or xyz.ndim != 2 or xyz.shape[1] != 3
            or not xyz.is_contiguous()):
        raise ValueError("fused kernel: xyz must be a contiguous float32 "
                         f"[N, 3] tensor, got {xyz.dtype} "
                         f"{tuple(xyz.shape)}")
    if (meta.dtype != torch.int64 or meta.ndim != 2 or meta.shape[1] != 5
            or meta.device.type != "cpu" or not meta.is_contiguous()):
        raise ValueError("fused kernel: meta must be a contiguous int64 "
                         f"[layers, 5] tensor on the CPU, got {meta.dtype} "
                         f"{tuple(meta.shape)} on {meta.device}")
    n_rows = int(meta[:, 1].sum())
    if (rows.dtype != torch.float32 or tuple(rows.shape) != (n_rows,)
            or not rows.is_contiguous() or rows.device != xyz.device):
        raise ValueError(f"fused kernel: rows must be a contiguous float32 "
                         f"[{n_rows}] tensor on {xyz.device}, got "
                         f"{rows.dtype} {tuple(rows.shape)} on "
                         f"{rows.device}")
    if (w.dtype != torch.bfloat16 or w.ndim != 1 or not w.is_contiguous()
            or w.device != xyz.device):
        raise ValueError(f"fused kernel: w must be a contiguous bfloat16 "
                         f"vector on {xyz.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")


@torch.library.custom_op("sdfldm::fused_eval", mutates_args=(),
                         device_types="cuda")
def fused_eval(xyz: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
               meta: torch.Tensor, use_tanh: bool) -> torch.Tensor:
    """One launch of kernel #1 on the current stream (see the module)."""
    check_operands(xyz, w, rows, meta)
    out = torch.empty(xyz.shape[0], dtype=torch.float32, device=xyz.device)
    rc = _fused_eval_lib().fused_eval_launch(
        xyz.data_ptr(), out.data_ptr(), xyz.shape[0], w.data_ptr(),
        rows.data_ptr(),
        ctypes.cast(meta.data_ptr(), ctypes.POINTER(ctypes.c_longlong)),
        meta.shape[0], int(use_tanh),
        torch.cuda.current_stream(xyz.device).cuda_stream)
    profiling.launched("fused_eval", rc)
    return out


@fused_eval.register_fake
def _(xyz, w, rows, meta, use_tanh):
    return xyz.new_empty(xyz.shape[0])


def eval_flops(n_points: int, meta) -> int:
    """FLOPs of one launch at `n_points`, as its plain version
    `packed_plain` counts them on the same operands: per row (k, n, kx) of
    the layer table, the product of the padded hidden inputs (k x n) and
    of the 3 xyz inputs (3 x n when kx), two FLOPs a multiply-add."""
    return 2 * n_points * sum(k * n + (3 * n if kx else 0)
                              for k, n, kx, _, _ in meta.tolist())


@register_flop_formula(torch.ops.sdfldm.fused_eval, get_raw=True)
def _(xyz, w, rows, meta, use_tanh, out_val=None):
    return eval_flops(xyz.shape[0], meta)


def unslab(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Inverse of ops.cuda_kernels.slab_order: K/16 slabs, flat -> the
    [n, K] weight."""
    return (flat.reshape(k // 16, n // 8, 2, 8, 8).permute(1, 3, 0, 2, 4)
            .reshape(n, k))


def packed_plain(xyz: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
                 meta: torch.Tensor, use_tanh: bool) -> torch.Tensor:
    """The plain version of the op on its packed operands: each layer's
    weights read back from the slab stream, bf16 operands multiplied as
    fp32, each layer's sum formed as fast_apply forms it (row, then the
    xyz product, then the hidden product)."""
    check_operands(xyz, w, rows, meta)
    g = EVAL_LAYOUT["stage_slabs"]
    xb = xyz.to(torch.bfloat16).float()
    h = out = None
    for k, n, kx, w_off, row_off in meta.tolist():
        acc = rows[row_off:row_off + n]
        if n == 1:                      # the final layer's padded vector
            out = acc + F.linear(h, w[w_off:w_off + k].float()[None])
            break
        at = w_off
        w_h = None
        if k:
            w_h = unslab(w[at:at + n * k], n, k).float()
            at += n * k
        if kx:
            w_x = unslab(w[at:at + n * g * kx], n, g * kx).float()
            acc = acc + F.linear(xb, w_x[:, :3])
        if w_h is not None:
            acc = acc + F.linear(h, w_h)
        h = torch.relu(acc).to(torch.bfloat16).float()
    if use_tanh:
        out = torch.tanh(out)
    return out[..., 0].contiguous()


fused_eval.register_kernel("cpu")(packed_plain)
