"""Hand-written CUDA kernels of the port, with their wrappers.

Counterpart of the JAX package's `ops/pallas_kernels.py`.

``make_kernel_apply`` (replaces ``make_pallas_apply``): fused SDF-decoder
evaluation, `csrc/fused_eval.cu`. Weight-norm folding happens once at
closure time; per call the wrapper computes the two hoisted latent rows
(b + bf16(z) @ w_z, plain GEMVs, as the TPU kernel's caller does) and
launches one kernel that runs every layer for a tile of points with the
activations in shared memory. Its plain version is
`ops.fused_decoder.fast_apply` in bf16: a wrapper given CPU tensors runs
that; given CUDA tensors it launches the kernel or raises.

``make_kernel_apply_pairs`` (replaces ``make_pallas_apply_pairs``): the same
evaluation where every point carries its own latent row,
`csrc/fused_eval_pairs.cu`. Nothing is hoisted: the latent products of
layer 0 and the skip layers run inside the kernel, from W_z slices packed
in fragment order beside the hidden weights, and every layer's row is its
bias, uploaded once. Its plain version is `fast_apply` in bf16 over the z
rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    EvalWeights, fast_apply, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)

_PAD = 64          # the kernel takes widths that are multiples of 64
MAX_WIDTH = 512    # csrc/fused_eval.cu MAX_WIDTH (checked at load)
MAX_LAYERS = 16    # csrc/fused_eval.cu MAX_LAYERS
MAX_LATENT = 512   # csrc/fused_eval_pairs.cu MAX_LATENT (checked at load)


def _pad_to(n: int) -> int:
    return -(-n // _PAD) * _PAD


def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """[N, K] bf16 weight (N, K multiples of 16) -> flat mma.sync B-fragment
    order [N/16][K/16][32 lanes][8]: lane (g, q) of an m16n8k16 product
    holds W[n0 + g, k0 + 2q + {0,1}] and W[n0 + g, k0 + 8 + 2q + {0,1}] for
    the even n8 tile, then the same for the odd one, so one 16-byte load
    gives it both tiles' fragments."""
    n, k = w.shape
    # (ntp, pair, g, kt, khalf, q, kk) -> (ntp, kt, g, q, pair, khalf, kk)
    return (w.reshape(n // 16, 2, 8, k // 16, 2, 4, 2)
            .permute(0, 3, 2, 5, 1, 4, 6).contiguous().reshape(-1))


def pack_weights(ew: EvalWeights) -> tuple:
    """The kernel's view of a folded decoder: (w_all bf16, wx_all bf16,
    meta int64 [n_layers, 5]). Hidden weights are zero-padded to widths
    that are multiples of 64 and stored in fragment order, the final
    layer's weight as a plain padded vector after them, each layer's w_x
    as [n, 3]; meta rows are (k, n, w_off, row_off, x_off) with x_off -1
    for layers without an xyz term. Raises on a plan the kernel does not
    take."""
    layers = ew.layers
    last = layers[-1]
    if (layers[0].w_h is not None or last.w_z is not None
            or last.b.shape[0] != 1
            or any(lay.w_h is None for lay in layers[1:])):
        raise ValueError("fused kernel: unsupported layer plan (needs a "
                         "latent first layer, hidden layers, and a plain "
                         "scalar final layer)")
    widths = [_pad_to(lay.b.shape[0]) for lay in layers[:-1]]
    if max(widths) > MAX_WIDTH or len(layers) > MAX_LAYERS:
        raise ValueError(f"fused kernel: {len(layers)} layers of padded "
                         f"width up to {max(widths)}; takes at most "
                         f"{MAX_LAYERS} of width {MAX_WIDTH}")
    # every part's size is a multiple of 64 elements, so each layer's
    # weights start 16-byte aligned (the kernel's uint4 loads)
    w_parts, x_parts, meta = [], [], []
    w_off = row_off = x_off = 0
    for i, lay in enumerate(layers):
        n = widths[i] if i < len(layers) - 1 else 1
        k = widths[i - 1] if i > 0 else 0
        wo, xo = w_off, -1
        if lay.w_x is not None:
            xo = x_off
            x_parts.append(_pad2(lay.w_x, n, 3).reshape(-1))
            x_off += n * 3
        if i == len(layers) - 1:
            w_parts.append(_pad2(lay.w_h, 1, k).reshape(-1))
            w_off += k
        elif i > 0:
            w_parts.append(fragment_order(_pad2(lay.w_h, n, k)))
            w_off += n * k
        meta.append((k, n, wo, row_off, xo))
        row_off += n
    bf = torch.bfloat16
    return (torch.cat(w_parts).to(bf).contiguous(),
            torch.cat(x_parts).to(bf).contiguous(),
            np.ascontiguousarray(meta, np.int64))


def hoisted_rows(ew: EvalWeights, meta: np.ndarray,
                 z: torch.Tensor) -> torch.Tensor:
    """Every layer's f32 bias row, padded to its width in `meta`,
    concatenated (the kernel's `rows`): b, plus bf16(z) @ w_z for layer 0
    and the skip layers."""
    zb = z.to(torch.bfloat16).float()
    rows = []
    for lay, n in zip(ew.layers, meta[:, 1].tolist()):
        row = lay.b
        if lay.w_z is not None:
            row = row + F.linear(zb, lay.w_z.float())
        rows.append(F.pad(row, (0, n - row.shape[0])))
    return torch.cat(rows).contiguous()


def pack_weights_pairs(ew: EvalWeights) -> tuple:
    """The pairs kernel's view of a folded decoder: (w_all bf16, wx_all
    bf16, rows f32, meta int64 [n_layers, 6], lz). pack_weights' buffers
    with each latent layer's W_z [n, lz] appended to w_all in fragment
    order, its latent columns zero-padded to lz (a multiple of 16); meta
    rows are (k, n, w_off, wz_off, row_off, x_off) with wz_off -1 for
    layers without a latent term; rows are the padded f32 biases."""
    w_all, wx_all, meta = pack_weights(ew)
    lz = -(-ew.latent_size // 16) * 16
    if lz > MAX_LATENT:
        raise ValueError(f"fused pairs kernel: latent size {ew.latent_size} "
                         f"> {MAX_LATENT}")
    parts, wz_off, off = [w_all], [], w_all.numel()
    for lay, n in zip(ew.layers, meta[:, 1].tolist()):
        if lay.w_z is None:
            wz_off.append(-1)
            continue
        wz_off.append(off)
        parts.append(fragment_order(_pad2(lay.w_z, n, lz)).to(w_all.dtype))
        off += n * lz
    rows = torch.cat([F.pad(lay.b, (0, n - lay.b.shape[0]))
                      for lay, n in zip(ew.layers, meta[:, 1].tolist())])
    meta6 = np.insert(meta, 3, wz_off, axis=1)
    return (torch.cat(parts).contiguous(), wx_all, rows.contiguous(),
            np.ascontiguousarray(meta6, np.int64), lz)


def _fused_eval_lib():
    lib = _build.load("fused_eval.cu")
    if not getattr(lib, "_argtypes_set", False):
        vp = ctypes.c_void_p
        lib.fused_eval_launch.restype = ctypes.c_int
        lib.fused_eval_launch.argtypes = [
            vp, vp, ctypes.c_longlong, vp, vp, vp,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            vp]
        lib.fused_eval_max_width.restype = ctypes.c_int
        lib.fused_eval_max_width.argtypes = []
        if lib.fused_eval_max_width() != MAX_WIDTH:
            raise RuntimeError("csrc/fused_eval.cu and cuda_kernels.py "
                               "disagree on the widest layer")
        lib._argtypes_set = True
    return lib


class KernelApply:
    """(z [L], xyz [N,3] f32) -> sdf [N] f32 through the fused kernel.

    `launches` counts kernel launches (one per call on a CUDA tensor);
    callers reset it to 0 before a run they want to account for."""

    def __init__(self, ew: EvalWeights, device: torch.device):
        self.ew = ew
        self.device = device
        self.launches = 0
        if device.type == "cuda":
            _fused_eval_lib()
            w_all, wx_all, self.meta = pack_weights(ew)
            self.w_all = w_all.to(device)
            self.wx_all = wx_all.to(device)

    def launch(self, xyz: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """One kernel launch on the current stream: xyz [N,3] f32 and the
        rows of hoisted_rows(self.ew, self.meta, z) -> sdf [N] f32."""
        if (xyz.dtype != torch.float32 or xyz.ndim != 2
                or xyz.shape[1] != 3 or not xyz.is_contiguous()):
            raise ValueError("fused kernel: xyz must be a contiguous "
                             f"float32 [N, 3] tensor, got {xyz.dtype} "
                             f"{tuple(xyz.shape)}")
        out = torch.empty(xyz.shape[0], dtype=torch.float32,
                          device=xyz.device)
        rc = _fused_eval_lib().fused_eval_launch(
            xyz.data_ptr(), out.data_ptr(), xyz.shape[0],
            self.w_all.data_ptr(), rows.data_ptr(),
            self.wx_all.data_ptr(),
            self.meta.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(self.meta), int(self.ew.use_tanh),
            torch.cuda.current_stream(xyz.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_eval_launch failed: cudaError {rc}")
        self.launches += 1
        return out

    def __call__(self, z: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        if xyz.device != self.device or z.device != self.device:
            raise ValueError(f"inputs on {xyz.device}/{z.device}, weights "
                             f"on {self.device}")
        if xyz.device.type == "cpu":
            return fast_apply(self.ew, z, xyz)
        return self.launch(xyz.float().contiguous(),
                           hoisted_rows(self.ew, self.meta, z))


def make_kernel_apply(decoder: SdfDecoder, params: dict,
                      device="cuda") -> KernelApply:
    """(z [L], xyz [N,3]) -> sdf [N]: the fused decoder-eval path.

    `params` is the decoder's state dict (utils.checkpoint.params_from_jax
    of a JAX tree, or `decoder.state_dict()`). On `cuda` (the default;
    raises when no card is present) every call launches the kernel; with
    `device="cpu"` every call runs the bf16 plain version."""
    dev = resolve_device(device)
    ew = precompute_eval_weights(decoder, params, torch.bfloat16, dev)
    return KernelApply(ew, dev)


def _fused_eval_pairs_lib():
    lib = _build.load("fused_eval_pairs.cu")
    if not getattr(lib, "_argtypes_set", False):
        vp = ctypes.c_void_p
        lib.fused_eval_pairs_launch.restype = ctypes.c_int
        lib.fused_eval_pairs_launch.argtypes = [
            vp, vp, ctypes.c_int, vp, ctypes.c_longlong, vp, vp, vp,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            vp]
        for fn in ("fused_eval_pairs_max_width",
                   "fused_eval_pairs_max_latent"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        if (lib.fused_eval_pairs_max_width() != MAX_WIDTH
                or lib.fused_eval_pairs_max_latent() != MAX_LATENT):
            raise RuntimeError("csrc/fused_eval_pairs.cu and cuda_kernels.py "
                               "disagree on the widest layer or latent")
        lib._argtypes_set = True
    return lib


class KernelApplyPairs:
    """(z_rows [N, L], xyz [N,3] f32) -> sdf [N] f32 through the fused
    pairs kernel: every point is evaluated with its own latent row.

    `launches` counts kernel launches (one per call on a CUDA tensor);
    callers reset it to 0 before a run they want to account for."""

    def __init__(self, ew: EvalWeights, device: torch.device):
        self.ew = ew
        self.device = device
        self.launches = 0
        if device.type == "cuda":
            _fused_eval_pairs_lib()
            w_all, wx_all, rows, self.meta, self.lz = pack_weights_pairs(ew)
            self.w_all = w_all.to(device)
            self.wx_all = wx_all.to(device)
            self.rows = rows.to(device)

    def launch(self, z_rows: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        """One kernel launch on the current stream: z_rows [N, lz] bf16
        (16-byte aligned) and xyz [N,3] f32, contiguous -> sdf [N] f32."""
        n = xyz.shape[0]
        if (xyz.dtype != torch.float32 or xyz.ndim != 2
                or xyz.shape[1] != 3 or not xyz.is_contiguous()):
            raise ValueError("fused pairs kernel: xyz must be a contiguous "
                             f"float32 [N, 3] tensor, got {xyz.dtype} "
                             f"{tuple(xyz.shape)}")
        if (z_rows.dtype != torch.bfloat16 or tuple(z_rows.shape) != (n, self.lz)
                or not z_rows.is_contiguous() or z_rows.data_ptr() % 16):
            raise ValueError("fused pairs kernel: z_rows must be a contiguous, "
                             f"16-byte aligned bfloat16 [{n}, {self.lz}] "
                             f"tensor, got {z_rows.dtype} "
                             f"{tuple(z_rows.shape)}")
        out = torch.empty(n, dtype=torch.float32, device=xyz.device)
        rc = _fused_eval_pairs_lib().fused_eval_pairs_launch(
            xyz.data_ptr(), z_rows.data_ptr(), self.lz, out.data_ptr(), n,
            self.w_all.data_ptr(), self.rows.data_ptr(),
            self.wx_all.data_ptr(),
            self.meta.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(self.meta), int(self.ew.use_tanh),
            torch.cuda.current_stream(xyz.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_eval_pairs_launch failed: cudaError {rc}")
        self.launches += 1
        return out

    def __call__(self, z_rows: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        if xyz.device != self.device or z_rows.device != self.device:
            raise ValueError(f"inputs on {xyz.device}/{z_rows.device}, "
                             f"weights on {self.device}")
        if z_rows.shape != (xyz.shape[0], self.ew.latent_size):
            raise ValueError(f"z_rows {tuple(z_rows.shape)} for "
                             f"{xyz.shape[0]} points of latent size "
                             f"{self.ew.latent_size}")
        if xyz.device.type == "cpu":
            return fast_apply(self.ew, z_rows, xyz)
        zb = F.pad(z_rows.to(torch.bfloat16),
                   (0, self.lz - z_rows.shape[1])).contiguous()
        if zb.data_ptr() % 16:
            zb = zb.clone()
        return self.launch(zb, xyz.float().contiguous())


def make_kernel_apply_pairs(decoder: SdfDecoder, params: dict,
                            device="cuda") -> KernelApplyPairs:
    """(z_rows [N, L], xyz [N,3]) -> sdf [N]: the per-point-latent fused
    decoder-eval path (the flat batched decode's evaluator).

    `params` as for make_kernel_apply. On `cuda` (the default; raises when
    no card is present) every call launches the kernel; with
    `device="cpu"` every call runs the bf16 plain version."""
    dev = resolve_device(device)
    ew = precompute_eval_weights(decoder, params, torch.bfloat16, dev)
    return KernelApplyPairs(ew, dev)
