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
`csrc/fused_eval_pairs.cu` (wgmma, weights streamed through shared memory
and shared by a thread-block cluster). Nothing is hoisted: the latent and
xyz products of layer 0 and the skip layers run inside the kernel, and
every layer's row is its bias, uploaded once. The kernel reads each
point's latent row itself, from a codes table [S, L] and an int32 shape
id per point (`KernelApplyPairs.indexed`); the (z_rows, xyz) call is the
case S = N, ids 0..N-1. `pack_weights_pairs` packs the weights as the
slab stream the kernel copies into shared memory as it is. Its plain
version is `fast_apply` in bf16 over codes[sids].
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
PAIRS_WIDTHS = (64, 128, 256, 512)   # the pairs kernel's padded widths
# csrc/fused_eval_pairs.cu's shared-memory layout (checked at load): bytes
# of a ring slot (one slab), the byte strides between 8x8 core matrices of
# a weight slab and of an activation or latent tile (wgmma's K-major layout
# without swizzle), next 8 inputs (LBO) and next 8 rows (SBO), and the
# slabs per ring stage (every layer's slab count is a multiple of it)
PAIRS_LAYOUT = dict(slot_bytes=16384, slab_lbo=128, slab_sbo=256,
                    tile_lbo=1024, tile_sbo=128, stage_slabs=2)


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


def slab_order(w: torch.Tensor) -> torch.Tensor:
    """[n, K] weight (n a multiple of 8, K of 16) -> its K/16 slabs, flat:
    slab j holds W[:, 16j:16j+16] in wgmma's K-major layout without
    swizzle, element (r, kk) at ((r // 8) * 2 + kk // 8) * 64 + (r % 8) * 8
    + kk % 8: 8x8 core matrices of 128 bytes, the next 8 inputs 128 bytes
    on (LBO), the next 8 rows 256 bytes on (SBO)."""
    n, k = w.shape
    return (w.reshape(n // 8, 8, k // 16, 2, 8).permute(2, 0, 3, 1, 4)
            .contiguous().reshape(-1))


def pairs_latent_widths(latent_size: int) -> tuple:
    """(lt, lzx): the codes table's row width (L padded to 8, 16-byte
    rows) and the latent tile's (lt + 3 xyz columns padded to 16)."""
    lt = -(-latent_size // 8) * 8
    return lt, -(-(lt + 3) // 16) * 16


def _pairs_width(n: int) -> int:
    for w in PAIRS_WIDTHS:
        if n <= w:
            return w
    raise ValueError(f"fused pairs kernel: layer width {n} > {MAX_WIDTH}")


def pack_weights_pairs(ew: EvalWeights) -> tuple:
    """The pairs kernel's view of a folded decoder: (w bf16, rows f32, meta
    int64 [n_layers, 5], lt, lzx).

    `w` is the slab stream the kernel walks for every tile: for each layer
    but the last, its hidden slabs (slab_order of W_h, widths padded to 64,
    128, 256 or 512) then its latent slabs (slab_order of [W_z | 0 | W_x |
    0], the latent columns padded to lt, then 3 xyz columns, padded to
    lzx), followed by zero slabs up to a multiple of the kernel's slabs
    per ring stage; then the final layer's weight as a plain padded
    vector. meta rows
    are (k, n, kz, w_off, row_off): padded hidden input width, output width
    (1 for the final layer), latent + xyz width (lzx or 0), bf16 offset in
    w, f32 offset of the padded bias in rows. Raises on a plan the kernel
    does not take."""
    layers = ew.layers
    last = layers[-1]
    if (layers[0].w_h is not None or last.w_z is not None
            or last.b.shape[0] != 1
            or any(lay.w_h is None for lay in layers[1:])
            or any((lay.w_z is None) != (lay.w_x is None) for lay in layers)):
        raise ValueError("fused pairs kernel: unsupported layer plan (needs "
                         "a latent first layer, hidden layers, and a plain "
                         "scalar final layer)")
    if ew.latent_size > MAX_LATENT:
        raise ValueError(f"fused pairs kernel: latent size {ew.latent_size} "
                         f"> {MAX_LATENT}")
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"fused pairs kernel: {len(layers)} layers; takes "
                         f"at most {MAX_LAYERS}")
    lt, lzx = pairs_latent_widths(ew.latent_size)
    widths = [_pairs_width(lay.b.shape[0]) for lay in layers[:-1]]
    # every part's size is a multiple of 64 elements, so each layer's
    # slabs start 16-byte aligned (the bulk copies' source alignment)
    parts, meta, rows = [], [], []
    w_off = row_off = 0
    for i, lay in enumerate(layers):
        n = widths[i] if i < len(layers) - 1 else 1
        k = widths[i - 1] if i > 0 else 0
        kz = lzx if lay.w_z is not None else 0
        meta.append((k, n, kz, w_off, row_off))
        if i == len(layers) - 1:
            parts.append(_pad2(lay.w_h, 1, k).reshape(-1))
        if i < len(layers) - 1 and k:
            parts.append(slab_order(_pad2(lay.w_h, n, k)))
        if kz:
            wz = _pad2(lay.w_z, lay.w_z.shape[0], lt)
            g = PAIRS_LAYOUT["stage_slabs"]
            kp = -(-lzx // (16 * g)) * 16 * g     # whole ring stages
            parts.append(slab_order(_pad2(torch.cat([wz, lay.w_x], 1), n,
                                          kp)))
        w_off = sum(p.numel() for p in parts)
        rows.append(F.pad(lay.b, (0, n - lay.b.shape[0])))
        row_off += n
    return (torch.cat([p.to(torch.bfloat16) for p in parts]).contiguous(),
            torch.cat(rows).contiguous(), np.asarray(meta, np.int64), lt,
            lzx)


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
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.fused_eval_pairs_launch.restype = i32
        lib.fused_eval_pairs_launch.argtypes = [
            vp, vp, i32, i32, vp, vp, i64, vp, vp, ctypes.POINTER(i64), i32,
            i32, i32, vp]
        lib.fused_eval_pairs_config.restype = i32
        lib.fused_eval_pairs_config.argtypes = [i32, ip, ip, ip, ip]
        lib.fused_eval_pairs_layout.restype = None
        lib.fused_eval_pairs_layout.argtypes = [ip]
        for fn in ("fused_eval_pairs_max_width",
                   "fused_eval_pairs_max_latent"):
            getattr(lib, fn).restype = i32
            getattr(lib, fn).argtypes = []
        layout = (ctypes.c_int * len(PAIRS_LAYOUT))()
        lib.fused_eval_pairs_layout(layout)
        if (lib.fused_eval_pairs_max_width() != MAX_WIDTH
                or lib.fused_eval_pairs_max_latent() != MAX_LATENT
                or list(layout) != list(PAIRS_LAYOUT.values())):
            raise RuntimeError("csrc/fused_eval_pairs.cu and cuda_kernels.py "
                               "disagree on the widest layer or latent, or "
                               "on the shared-memory layout")
        lib._argtypes_set = True
    return lib


class KernelApplyPairs:
    """(z_rows [N, L], xyz [N,3] f32) -> sdf [N] f32 through the fused
    pairs kernel: every point is evaluated with its own latent row.
    `indexed(codes [S, L], sids [N], xyz)` evaluates point p with
    codes[sids[p]], the kernel reading the rows itself.

    `launches` counts kernel launches (one per call on a CUDA tensor);
    callers reset it to 0 before a run they want to account for."""

    def __init__(self, ew: EvalWeights, device: torch.device):
        self.ew = ew
        self.device = device
        self.launches = 0
        if device.type == "cuda":
            _fused_eval_pairs_lib()
            w, rows, self.meta, self.lt, self.lzx = pack_weights_pairs(ew)
            self.w = w.to(device)
            self.rows = rows.to(device)

    def config(self) -> dict:
        """The launch configuration on this card: ring stages, dynamic
        shared memory (bytes), clusters resident at once, CTAs a cluster."""
        out = [ctypes.c_int() for _ in range(4)]
        rc = _fused_eval_pairs_lib().fused_eval_pairs_config(
            self.lzx, *[ctypes.byref(o) for o in out])
        if rc != 0:
            raise RuntimeError(f"fused_eval_pairs_config failed: cudaError {rc}")
        return dict(zip(("stages", "smem", "max_clusters", "cluster"),
                        (o.value for o in out)))

    def launch(self, codes: torch.Tensor, sids: torch.Tensor,
               xyz: torch.Tensor) -> torch.Tensor:
        """One kernel launch on the current stream: codes [S, lt] bf16
        (16-byte aligned), sids [N] int32 in [0, S) and xyz [N,3] f32, all
        contiguous -> sdf [N] f32. An id outside [0, S) traps the kernel."""
        n = xyz.shape[0]
        if (xyz.dtype != torch.float32 or xyz.ndim != 2
                or xyz.shape[1] != 3 or not xyz.is_contiguous()):
            raise ValueError("fused pairs kernel: xyz must be a contiguous "
                             f"float32 [N, 3] tensor, got {xyz.dtype} "
                             f"{tuple(xyz.shape)}")
        if (sids.dtype != torch.int32 or tuple(sids.shape) != (n,)
                or not sids.is_contiguous()):
            raise ValueError(f"fused pairs kernel: sids must be a contiguous "
                             f"int32 [{n}] tensor, got {sids.dtype} "
                             f"{tuple(sids.shape)}")
        if (codes.dtype != torch.bfloat16 or codes.ndim != 2
                or codes.shape[1] != self.lt or codes.shape[0] < 1
                or not codes.is_contiguous() or codes.data_ptr() % 16):
            raise ValueError("fused pairs kernel: codes must be a contiguous, "
                             f"16-byte aligned bfloat16 [S, {self.lt}] "
                             f"tensor, got {codes.dtype} "
                             f"{tuple(codes.shape)}")
        for t in (codes, sids):
            if t.device != xyz.device:
                raise ValueError(f"fused pairs kernel: inputs on {t.device} "
                                 f"and {xyz.device}")
        out = torch.empty(n, dtype=torch.float32, device=xyz.device)
        rc = _fused_eval_pairs_lib().fused_eval_pairs_launch(
            xyz.data_ptr(), codes.data_ptr(), self.lt, codes.shape[0],
            sids.data_ptr(), out.data_ptr(), n, self.w.data_ptr(),
            self.rows.data_ptr(),
            self.meta.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(self.meta), self.lzx, int(self.ew.use_tanh),
            torch.cuda.current_stream(xyz.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_eval_pairs_launch failed: cudaError {rc}")
        self.launches += 1
        return out

    def table(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [S, L] -> the kernel's table: bf16 [S, lt], contiguous,
        16-byte aligned (the same tensor when it already is one)."""
        t = codes.to(torch.bfloat16)
        if t.shape[1] != self.lt:
            t = F.pad(t, (0, self.lt - t.shape[1]))
        t = t.contiguous()
        return t.clone() if t.data_ptr() % 16 else t

    def _check(self, codes, xyz, n_rows, what):
        if xyz.device != self.device or codes.device != self.device:
            raise ValueError(f"inputs on {xyz.device}/{codes.device}, "
                             f"weights on {self.device}")
        if codes.ndim != 2 or codes.shape[1] != self.ew.latent_size or (
                n_rows is not None and codes.shape[0] != n_rows):
            raise ValueError(f"{what} {tuple(codes.shape)} for "
                             f"{xyz.shape[0]} points of latent size "
                             f"{self.ew.latent_size}")

    def indexed(self, codes: torch.Tensor, sids: torch.Tensor,
                xyz: torch.Tensor) -> torch.Tensor:
        """(codes [S, L], sids [N] integer, xyz [N,3]) -> sdf [N]: point p
        with latent codes[sids[p]]. On the CPU the plain version over
        codes[sids]; on the card one launch, no gathered rows."""
        self._check(codes, xyz, None, "codes")
        if sids.shape != (xyz.shape[0],) or sids.device != self.device:
            raise ValueError(f"sids {tuple(sids.shape)} on {sids.device} for "
                             f"{xyz.shape[0]} points on {self.device}")
        if xyz.device.type == "cpu":
            return fast_apply(self.ew, codes[sids.long()], xyz)
        return self.launch(self.table(codes),
                           sids.to(torch.int32).contiguous(),
                           xyz.float().contiguous())

    def __call__(self, z_rows: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        self._check(z_rows, xyz, xyz.shape[0], "z_rows")
        if xyz.device.type == "cpu":
            return fast_apply(self.ew, z_rows, xyz)
        if xyz.shape[0] == 0:
            return torch.empty(0, dtype=torch.float32, device=xyz.device)
        return self.launch(self.table(z_rows),
                           torch.arange(xyz.shape[0], dtype=torch.int32,
                                        device=xyz.device),
                           xyz.float().contiguous())


def make_kernel_apply_pairs(decoder: SdfDecoder, params: dict,
                            device="cuda") -> KernelApplyPairs:
    """(z_rows [N, L], xyz [N,3]) -> sdf [N], and `.indexed(codes, sids,
    xyz)`: the per-point-latent fused decoder-eval path (the flat batched
    decode's evaluator).

    `params` as for make_kernel_apply. On `cuda` (the default; raises when
    no card is present) every call launches the kernel; with
    `device="cpu"` every call runs the bf16 plain version."""
    dev = resolve_device(device)
    ew = precompute_eval_weights(decoder, params, torch.bfloat16, dev)
    return KernelApplyPairs(ew, dev)
