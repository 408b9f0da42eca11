"""Hand-written CUDA kernels of the port, with their wrappers.

Counterpart of the JAX package's `ops/pallas_kernels.py`.

``make_kernel_apply`` (replaces ``make_pallas_apply``): fused SDF-decoder
evaluation for one latent, `csrc/fused_eval.cu` (wgmma, weights streamed
through shared memory and shared by a thread-block cluster). Weight-norm
folding happens once at closure time; per call the wrapper computes every
layer's row, with the latent products of layer 0 and the skip layers
hoisted into it (b + bf16(z) @ w_z, plain GEMVs, as the TPU kernel's
caller does), and launches one kernel that runs every layer for a tile of
points with the activations in shared memory; only the xyz products run
per point. `pack_weights` packs the weights as the slab stream the kernel
copies into shared memory as it is. Its plain version is
`ops.fused_decoder.fast_apply` in bf16: a wrapper given CPU tensors runs
that; given CUDA tensors it launches the kernel or raises.

``make_kernel_apply_pairs`` (replaces ``make_pallas_apply_pairs``): the same
evaluation where every point carries its own latent row,
`csrc/fused_eval_pairs.cu` (the same engine with a latent tile). Nothing
is hoisted: the latent and xyz products of layer 0 and the skip layers run
inside the kernel, and every layer's row is its bias, uploaded once. The
kernel reads each point's latent row itself, from a codes table [S, L]
and an int32 shape id per point (`KernelApplyPairs.indexed`); the
(z_rows, xyz) call is the case S = N, ids 0..N-1. `pack_weights_pairs`
packs its slab stream. Its plain version is `fast_apply` in bf16 over
codes[sids].

Each launch is recorded, NaN-checked and costed by `utils.profiling`:
kernel #1 as the op `sdfldm::fused_eval`, kernel #2 through `launched`
in `KernelApplyPairs.launch` (`pairs_flops`).
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
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_eval_op import (  # noqa: F401
    EVAL_LAYOUT, EVAL_WIDTHS, MAX_LATENT, MAX_LAYERS, MAX_WIDTH,
    PAIRS_LAYOUT, _fused_eval_lib, fused_eval)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)

def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))


def _check_plan(ew: EvalWeights, what: str) -> list:
    """The padded widths of a plan's layers (1 for the final one); raises
    unless it has a latent first layer, hidden layers and a plain scalar
    final layer, at most MAX_LAYERS of width <= MAX_WIDTH."""
    layers = ew.layers
    last = layers[-1]
    if (layers[0].w_h is not None or last.w_z is not None
            or last.b.shape[0] != 1
            or any(lay.w_h is None for lay in layers[1:])
            or any((lay.w_z is None) != (lay.w_x is None) for lay in layers)):
        raise ValueError(f"{what}: unsupported layer plan (needs a latent "
                         "first layer, hidden layers, and a plain scalar "
                         "final layer)")
    widest = max(lay.b.shape[0] for lay in layers[:-1])
    if widest > MAX_WIDTH or len(layers) > MAX_LAYERS:
        raise ValueError(f"{what}: {len(layers)} layers of width up to "
                         f"{widest}; takes at most {MAX_LAYERS} of width "
                         f"{MAX_WIDTH}")
    return [next(w for w in EVAL_WIDTHS if lay.b.shape[0] <= w)
            for lay in layers[:-1]] + [1]


def pack_weights(ew: EvalWeights) -> tuple:
    """Kernel #1's view of a folded decoder: (w bf16, meta int64
    [n_layers, 5]).

    `w` is the slab stream the kernel walks for every tile: for each layer
    but the last, its hidden slabs (slab_order of W_h, widths padded to 64,
    128, 256 or 512), then for layer 0 and the skip layers one xyz slab
    (slab_order of [W_x | 0], 16 inputs) followed by zero slabs up to a
    whole ring stage; then the final layer's weight as a plain padded
    vector. The latent products are not in it: hoisted_rows adds them to
    the rows per launch. meta rows are (k, n, kx, w_off, row_off): padded
    hidden input width, output width (1 for the final layer), xyz input
    width (16 or 0), bf16 offset in w, f32 offset of the layer's row in
    hoisted_rows. Raises on a plan the kernel does not take."""
    widths = _check_plan(ew, "fused kernel")
    xk, g = EVAL_LAYOUT["xyz_cols"], EVAL_LAYOUT["stage_slabs"]
    # every part's size is a multiple of 64 elements, so each layer's
    # slabs start 16-byte aligned (the bulk copies' source alignment)
    parts, meta = [], []
    w_off = row_off = 0
    for i, lay in enumerate(ew.layers):
        n, k = widths[i], widths[i - 1] if i else 0
        kx = xk if lay.w_x is not None else 0
        meta.append((k, n, kx, w_off, row_off))
        if n == 1:
            parts.append(_pad2(lay.w_h, 1, k).reshape(-1))
        elif k:
            parts.append(slab_order(_pad2(lay.w_h, n, k)))
        if kx:
            parts.append(slab_order(_pad2(lay.w_x, n, g * xk)))
        w_off = sum(p.numel() for p in parts)
        row_off += n
    return (torch.cat([p.to(torch.bfloat16) for p in parts]).contiguous(),
            np.asarray(meta, np.int64))


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
    widths = _check_plan(ew, "fused pairs kernel")
    if ew.latent_size > MAX_LATENT:
        raise ValueError(f"fused pairs kernel: latent size {ew.latent_size} "
                         f"> {MAX_LATENT}")
    lt, lzx = pairs_latent_widths(ew.latent_size)
    # every part's size is a multiple of 64 elements, so each layer's
    # slabs start 16-byte aligned (the bulk copies' source alignment)
    parts, meta, rows = [], [], []
    w_off = row_off = 0
    for i, lay in enumerate(ew.layers):
        n, k = widths[i], widths[i - 1] if i else 0
        kz = lzx if lay.w_z is not None else 0
        meta.append((k, n, kz, w_off, row_off))
        if n == 1:
            parts.append(_pad2(lay.w_h, 1, k).reshape(-1))
        elif k:
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


class KernelApply:
    """(z [L], xyz [N,3] f32) -> sdf [N] f32 through the fused kernel.

    `launches` counts the launches of this wrapper's calls (one per call
    on a CUDA tensor, as the op recorded them; an exported program's only
    in `utils.profiling.LAUNCHES`); callers reset it to 0 before a run
    they want to account for. `meta` is the layer table as a numpy array,
    `meta_t` as the CPU tensor the op reads."""

    def __init__(self, ew: EvalWeights, device: torch.device):
        self.ew = ew
        self.device = device
        self.launches = 0
        if device.type == "cuda":
            _fused_eval_lib()
            w, self.meta = pack_weights(ew)
            self.meta_t = torch.from_numpy(self.meta)
            self.w = w.to(device)

    def config(self) -> dict:
        """The launch configuration on this card: ring stages, dynamic
        shared memory (bytes), clusters resident at once, CTAs a cluster."""
        out = [ctypes.c_int() for _ in range(4)]
        rc = _fused_eval_lib().fused_eval_config(
            *[ctypes.byref(o) for o in out])
        if rc != 0:
            raise RuntimeError(f"fused_eval_config failed: cudaError {rc}")
        return dict(zip(("stages", "smem", "max_clusters", "cluster"),
                        (o.value for o in out)))

    def launch(self, xyz: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """One kernel launch on the current stream, through the custom op
        `sdfldm::fused_eval` (so `torch.export` traces it): xyz [N,3] f32
        and the rows of hoisted_rows(self.ew, self.meta, z) -> sdf [N]
        f32."""
        n0 = profiling.LAUNCHES["fused_eval"]
        out = fused_eval(xyz, self.w, rows, self.meta_t, self.ew.use_tanh)
        self.launches += profiling.LAUNCHES["fused_eval"] - n0
        return out

    def __call__(self, z: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        if xyz.device != self.device or z.device != self.device:
            raise ValueError(f"inputs on {xyz.device}/{z.device}, weights "
                             f"on {self.device}")
        if xyz.device.type == "cpu":
            return fast_apply(self.ew, z, xyz)
        return self.launch(xyz.float().contiguous(),
                           hoisted_rows(self.ew, self.meta, z))

    def bind(self, z: torch.Tensor):
        """xyz [N,3] -> sdf [N] at the one latent z, whose rows are hoisted
        once (hoisted_rows): every call on the card is one launch and
        nothing else. On the CPU each call runs the plain version."""
        if z.device != self.device:
            raise ValueError(f"z on {z.device}, weights on {self.device}")
        if self.device.type == "cpu":
            return lambda xyz: fast_apply(self.ew, z, xyz)
        rows = hoisted_rows(self.ew, self.meta, z)
        return lambda xyz: self.launch(xyz.float().contiguous(), rows)


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


def pairs_flops(ew: EvalWeights, n_points: int) -> int:
    """FLOPs of kernel #2 at `n_points`, as its plain version (fast_apply
    over a latent row per point) counts them: every layer's latent, xyz
    and hidden products at their true widths, two FLOPs a multiply-add."""
    return 2 * n_points * sum(t.numel() for lay in ew.layers
                              for t in (lay.w_h, lay.w_z, lay.w_x)
                              if t is not None)


class KernelApplyPairs:
    """(z_rows [N, L], xyz [N,3] f32) -> sdf [N] f32 through the fused
    pairs kernel: every point is evaluated with its own latent row.
    `indexed(codes [S, L], sids [N], xyz)` evaluates point p with
    codes[sids[p]], the kernel reading the rows itself.

    `launches` counts kernel launches (one per call on a CUDA tensor, as
    recorded); callers reset it to 0 before a run they account for."""

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
        n0 = profiling.LAUNCHES["fused_eval_pairs"]
        rc = _fused_eval_pairs_lib().fused_eval_pairs_launch(
            xyz.data_ptr(), codes.data_ptr(), self.lt, codes.shape[0],
            sids.data_ptr(), out.data_ptr(), n, self.w.data_ptr(),
            self.rows.data_ptr(),
            self.meta.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(self.meta), self.lzx, int(self.ew.use_tanh),
            torch.cuda.current_stream(xyz.device).cuda_stream)
        # xyz in, sdf out, 4-byte ids, the table and the weights, once
        profiling.launched(
            "fused_eval_pairs", rc, codes, xyz, out,
            flops=pairs_flops(self.ew, n),
            nbytes=20 * n + codes.nbytes + self.w.nbytes + self.rows.nbytes)
        self.launches += profiling.LAUNCHES["fused_eval_pairs"] - n0
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
