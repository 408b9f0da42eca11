"""Fused training pass of the SDF decoder (kernel #4).

Counterpart of the JAX package's `ops/fused_train.py`
(`_build_train_kernel`, `fused_train_loss_grads`,
`make_pallas_ad_loss_grads`), ported to `csrc/fused_train.cu`.

`fused_train_loss_grads(ew, z, xyz, sdf, ...)` takes the folded decoder
(`ops.fused_decoder.precompute_eval_weights` in bf16: torch layout
[out, in], latent and xyz slices split off at layer 0 and the skip layer)
and returns (loss_l1, dz [S, L], grads), grads being one dict per layer
with the f32 gradients of the folded `w_h`, `w_z`, `w_x` and `b`. On CPU
tensors it runs the plain version `fused_train_reference`; on CUDA tensors
it launches the kernels or raises, and counts one "fused_train" per pass
in `utils.profiling.LAUNCHES`.

Rounding follows the TPU kernel: z and xyz rounded to bf16 (z stays f32 in
dW_z), every hidden activation bf16 after relu and dropout, dpred and
every masked gradient bf16, gsum rounded to bf16 before the dz product
(per scene here, per 256-point tile on the TPU). Dropout draws the Philox
mask of `ops.relu_dropout` for layer seed seed + 7919 * layer and row =
the point's index in the flat [S*P] batch, so with dropout on this pass
sees the same mask as the decoder's `dropout_impl="pallas"` forward.

The forward, dgrad and wgrad GEMMs of the pass run on the kernel's
Hopper GEMM engine (TMA ring, wgmma, persistent CTAs; wgrad with both
operands transposed and split-K over fixed chunks of points; the layouts
are modelled in `ops.train_gemm`), callable alone as `gemm_fwd` /
`gemm_dgrad` / `gemm_wgrad` with plain versions `gemm_fwd_reference` /
`gemm_dgrad_reference` / `gemm_wgrad_reference`. The forward (and
`layer0`, the K = 3 first layer) also writes one keep bit per element of
its output, bf16(h) > 0 (`ops.train_gemm.pack_keep_bits`), and the dgrad
masks with those bits instead of reading the activation; the dgrad also
emits each 128-point tile's column sums of its output
(`column_partials_reference`), from which the pass takes db, the
per-scene gsum and, at layer 0 and the skip layer, the xyz-weighted sums.

`make_fused_ad_loss_grads(decoder, cfg)` is the training step's loss and
gradient function: it folds the decoder's parameters with torch autograd
recording, runs the pass on the folded weights, chains the folded
gradients back to (v, g, b) with `torch.autograd.backward` (the JAX
package's `refold_loss` vjp), adds the code regulariser's gradient and
scatters the dz rows into the dense code gradient with `index_add_`
(scene ids repeat in a padded batch).

Every launch reports to `utils.profiling.launched` under its name (the
pass's own kernels under their launchers', "ft_reduce", ...), the roles
("gemm_fwd", "gemm_dgrad", "gemm_wgrad", "layer0") with a NaN check of
what each reads and writes and their work. The pass counts as one kernel,
"fused_train" (`train_flops`: its plain version's FLOPs; its inputs and
outputs once); the roles it launches count their work only when alone.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
from torch.nn import functional as F

from latent_diffusion_models_for_shape_sdfs_torch import losses
from latent_diffusion_models_for_shape_sdfs_torch.config import AdConfig
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.models.latent_table import (
    gather_codes)
from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
from latent_diffusion_models_for_shape_sdfs_torch.ops.train_gemm import (
    TN_LAYOUT, WGRAD_LAYOUT, check_shape, check_wgrad_shape, pack_keep_bits,
    unpack_keep_bits, wgrad_chunk)
from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_decoder import (
    EvalLayer, EvalWeights, precompute_eval_weights)
from latent_diffusion_models_for_shape_sdfs_torch.ops.relu_dropout import (
    dropout_keep_mask, keep_threshold, layer_seed)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

FINAL_ROWS = 64     # points per tile of the final layer's kernel
_PAD = 128          # hidden widths are padded to the GEMMs' tile rows
_KEYS = ("w_h", "w_z", "w_x", "b")


def _pad_to(n: int) -> int:
    return -(-n // _PAD) * _PAD


def macs_per_point(ew: EvalWeights) -> int:
    """Multiply-adds per point of one pass at the layers' true widths:
    forward (hidden and xyz inputs; the latent rows are per scene), wgrad
    (the same products) and dgrad (the hidden inputs only)."""
    fwd = hidden = 0
    for lay in ew.layers:
        if lay.w_x is not None:
            fwd += lay.w_x.numel()
        if lay.w_h is not None:
            fwd += lay.w_h.numel()
            hidden += lay.w_h.numel()
    return 2 * fwd + hidden


def train_flops(ew: EvalWeights, n_scenes: int, points: int) -> int:
    """FLOPs of one pass over n_scenes x points, as its plain version
    counts them: macs_per_point for every point, and per scene the latent
    rows of layer 0 and the skip layers, their weight gradient and dz
    (three [L] x [L, H] products each), two FLOPs a multiply-add."""
    rows = sum(lay.w_z.numel() for lay in ew.layers if lay.w_z is not None)
    return 2 * (n_scenes * points * macs_per_point(ew) + 3 * n_scenes * rows)


# ------------------------------------------------------------ plain version


def fused_train_reference(ew: EvalWeights, z: torch.Tensor,
                          xyz: torch.Tensor, sdf: torch.Tensor,
                          num_sdf_samples: int, clamp_dist: float,
                          rate: float, seed: int) -> tuple:
    """The pass in plain torch, with the kernel's rounding points: bf16
    operands multiplied in f32, f32 sums. z [S, L], xyz [S, P, 3],
    sdf [S, P]."""
    S, P, _ = xyz.shape
    N = S * P
    n_lin = len(ew.layers)
    bf = torch.bfloat16
    inv_n = 1.0 / num_sdf_samples
    scale = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    zf = z.float()
    zb = zf.to(bf).float()
    xb = xyz.reshape(N, 3).to(bf).float()
    sid = torch.arange(S, device=z.device).repeat_interleave(P)

    acts = []           # bf16 post-activation of every hidden layer
    h = None
    for i, lay in enumerate(ew.layers):
        acc = lay.b.float()
        if lay.w_z is not None:
            rows = acc + F.linear(zb, lay.w_z.float())
            acc = rows[sid] + F.linear(xb, lay.w_x.float())
        if lay.w_h is not None:
            acc = acc + F.linear(h.float(), lay.w_h.float())
        if i < n_lin - 1:
            a = torch.relu(acc)
            if rate > 0:
                keep = dropout_keep_mask(N, a.shape[1], layer_seed(seed, i),
                                         rate, device=a.device)
                a = torch.where(keep, a * scale, 0.0)
            h = a.to(bf)
            acts.append(h)
        else:
            pred = acc[:, 0]

    pc = torch.clamp(pred, -clamp_dist, clamp_dist)
    gc = torch.clamp(sdf.reshape(N).float(), -clamp_dist, clamp_dist)
    diff = pc - gc
    loss = torch.sum(torch.abs(diff)) * inv_n
    dpred = torch.where(torch.abs(pred) < clamp_dist,
                        torch.sign(diff) * inv_n, 0.0)
    g = dpred.to(bf).float()[:, None]                  # [N, 1]

    dz = torch.zeros_like(zf)
    grads = [None] * n_lin
    for i in range(n_lin - 1, -1, -1):
        lay = ew.layers[i]
        gr = {"b": g.sum(0)}
        if lay.w_h is not None:
            gr["w_h"] = g.T @ acts[i - 1].float()
        if lay.w_z is not None:
            gsum = g.reshape(S, P, -1).sum(1)           # [S, H]
            gr["w_z"] = gsum.T @ zf
            gr["w_x"] = g.T @ xb
            dz = dz + gsum.to(bf).float() @ lay.w_z.float()
        grads[i] = gr
        if i > 0:
            gh = g @ lay.w_h.float()
            g = torch.where(acts[i - 1] > 0, gh * scale, 0.0).to(bf).float()
    return loss, dz, grads


# ------------------------------------------------------------ the kernels


def _lib():
    lib = _build.load("fused_train.cu")
    if not getattr(lib, "_argtypes_set", False):
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        u32, f32 = ctypes.c_uint32, ctypes.c_float
        sig = {
            "ft_gemm_fwd": [vp, vp, i32, i32, i32, i32, vp, ll, ll, vp, vp,
                            u32, u32, f32, i32, vp, vp, vp],
            "ft_gemm_dgrad": [vp, vp, i32, i32, i32, i32, vp, vp, f32, vp,
                              vp, vp],
            "ft_gemm_wgrad": [vp, vp, i32, i32, ll, ll, i32, vp, vp],
            "ft_scene_rows": [vp, vp, vp, vp, i32, i32, i32, vp],
            "ft_layer0": [vp, vp, vp, vp, vp, ll, ll, i32, i32, u32, u32,
                          f32, i32, vp],
            "ft_final": [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, i32,
                         f32, f32, f32, vp],
            "ft_reduce": [vp, vp, i32, i32, ll, ll, vp],
            "ft_dz": [vp, vp, vp, i32, i32, i32, i32, vp],
            "ft_dwz": [vp, vp, vp, i32, i32, i32, vp],
        }
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        consts = (ctypes.c_int * 1)()
        lib.ft_constants.restype = None
        lib.ft_constants(consts)
        layout = (ctypes.c_int * len(TN_LAYOUT))()
        lib.ft_gemm_layout.restype = None
        lib.ft_gemm_layout(layout)
        wlayout = (ctypes.c_int * len(WGRAD_LAYOUT))()
        lib.ft_wgrad_layout.restype = None
        lib.ft_wgrad_layout(wlayout)
        if (list(consts) != [FINAL_ROWS]
                or list(layout) != list(TN_LAYOUT.values())
                or list(wlayout) != list(WGRAD_LAYOUT.values())):
            raise RuntimeError("csrc/fused_train.cu and fused_train.py / "
                               "train_gemm.py disagree on tile sizes or the "
                               f"GEMM layouts: {list(consts)} {list(layout)} "
                               f"{list(wlayout)}")
        lib._argtypes_set = True
    return lib


def _call(name: str, *args) -> None:
    """One launch of the pass's kernel `name`, reported to the record."""
    profiling.launched(name, getattr(_lib(), name)(*args))


def _ptr(t):
    return None if t is None else t.data_ptr()


def gemm_fwd_reference(h: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
                       p: int, xyz=None, wx=None, seed: int = 0,
                       rate: float = 0.0) -> torch.Tensor:
    """Plain version of the forward GEMM role: bf16(drop(relu(h W^T +
    rows[row // p] (+ xyz wx^T)))) from bf16 operands with f32 sums; rows
    [1, N] (one bias row) or [M // p, N] (a row per scene), f32; the
    dropout mask of `ops.relu_dropout` for layer seed `seed`."""
    acc = h.float() @ w.float().T
    if rows.shape[0] == 1:
        acc = acc + rows.float()
    else:
        acc = acc + rows.float().repeat_interleave(p, 0)
    if xyz is not None:
        acc = acc + xyz.float() @ wx.float().T
    a = torch.relu(acc)
    if rate > 0:
        keep = dropout_keep_mask(a.shape[0], a.shape[1], seed, rate,
                                 device=a.device)
        a = torch.where(keep, a * (1.0 / (1.0 - rate)), 0.0)
    return a.to(torch.bfloat16)


def gemm_dgrad_reference(g: torch.Tensor, wt: torch.Tensor,
                         keep_bits: torch.Tensor, scale: float
                         ) -> torch.Tensor:
    """Plain version of the dgrad GEMM role: bf16(where(keep, (g wt^T) *
    scale, 0)), wt = W^T [in][out], keep the [M, N] mask of `keep_bits`
    (pack_keep_bits(hprev > 0): the same predicate as hprev > 0)."""
    keep = unpack_keep_bits(keep_bits, g.shape[0], wt.shape[0])
    return torch.where(keep, (g.float() @ wt.float().T) * scale,
                       0.0).to(torch.bfloat16)


def column_partials_reference(g: torch.Tensor, xyz=None,
                              rows: int = TN_LAYOUT["bm"]) -> torch.Tensor:
    """Plain version of the column partials the dgrad role (rows 128) and
    the final layer's kernel (rows 64) emit: per tile of `rows` points,
    the column sums of g [M, N] (bf16, summed in f32), and with xyz [M, 3]
    the three bf16(xyz)-weighted sums: f32 [M // rows, (1 or 4) * N]."""
    m, n = g.shape
    gf = g.float().reshape(m // rows, rows, n)
    sums = [gf.sum(1)]
    if xyz is not None:
        xf = xyz.to(torch.bfloat16).float().reshape(m // rows, rows, 3)
        sums += list(torch.einsum("trc,trn->ctn", xf, gf))
    return torch.stack(sums, 1).reshape(m // rows, -1)


def _gemm_operands(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """Checks the two bf16 operands of an engine launch; returns the tile
    width."""
    for t in (a, b):
        if (t.dtype != torch.bfloat16 or t.ndim != 2 or not t.is_contiguous()
                or t.device != a.device or t.data_ptr() % 16):
            raise ValueError(f"{what}: operands must be contiguous, 16-byte "
                             f"aligned bf16 matrices on one device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"{what}: K of {tuple(a.shape)} and {tuple(b.shape)}")
    return check_shape(a.shape[0], b.shape[0], a.shape[1])


def gemm_fwd(h: torch.Tensor, w: torch.Tensor, rows: torch.Tensor, p: int,
             xyz=None, wx=None, seed: int = 0, rate: float = 0.0,
             keep_bits: bool = False):
    """The forward GEMM role, h [M, K] x W [N, K] (bf16) -> h' [M, N] bf16
    (see gemm_fwd_reference), and with keep_bits also (h', its keep bits
    pack_keep_bits(h' > 0), int32 [M N / 32]): the plain version on CPU
    tensors, one launch of the engine on CUDA tensors (M and p multiples
    of 128, K of 64, N of 128; raises otherwise)."""
    if h.device.type == "cpu":
        out = gemm_fwd_reference(h, w, rows, p, xyz, wx, seed, rate)
        return (out, pack_keep_bits(out > 0)) if keep_bits else out
    bn = _gemm_operands(h, w, "gemm_fwd")
    m, n = h.shape[0], w.shape[0]
    if (rows.dtype != torch.float32 or not rows.is_contiguous()
            or rows.shape[1:] != (n,) or rows.device != h.device
            or rows.shape[0] not in (1, m // max(p, 1)) or p <= 0
            or m % p or p % TN_LAYOUT["bm"]):
        raise ValueError(f"gemm_fwd: rows {rows.dtype} {tuple(rows.shape)} "
                         f"for {m} points, {p} per scene (a multiple of "
                         f"{TN_LAYOUT['bm']}), width {n}")
    if xyz is not None and (
            xyz.dtype != torch.bfloat16 or tuple(xyz.shape) != (m, 3)
            or not xyz.is_contiguous() or xyz.device != h.device
            or wx is None or wx.dtype != torch.bfloat16
            or tuple(wx.shape) != (n, 3) or not wx.is_contiguous()
            or wx.device != h.device):
        raise ValueError("gemm_fwd: xyz must be bf16 [M, 3] with wx bf16 "
                         "[N, 3], both contiguous and on h's device")
    out = torch.empty(m, n, dtype=torch.bfloat16, device=h.device)
    bits = (torch.empty(m * n // 32, dtype=torch.int32, device=h.device)
            if keep_bits else None)
    drop = int(rate > 0)
    rc = _lib().ft_gemm_fwd(
        h.data_ptr(), w.data_ptr(), m, n, h.shape[1], bn, rows.data_ptr(),
        0 if rows.shape[0] == 1 else n, p, _ptr(xyz), _ptr(wx),
        seed & 0xFFFFFFFF, keep_threshold(rate),
        1.0 / (1.0 - rate) if drop else 1.0, drop, out.data_ptr(),
        _ptr(bits), torch.cuda.current_stream(h.device).cuda_stream)
    ins = (h, w, rows) if xyz is None else (h, w, rows, xyz, wx)
    outs = (out,) if bits is None else (out, bits)
    profiling.launched("gemm_fwd", rc, *ins, out, flops=2 * m * n * (
        h.shape[1] + (0 if xyz is None else 3)), nbytes=_nbytes(*ins, *outs))
    return outs if keep_bits else out


def _check_keep_bits(keep_bits: torch.Tensor, m: int, n: int, device,
                     what: str) -> None:
    if (keep_bits.dtype != torch.int32 or keep_bits.ndim != 1
            or keep_bits.numel() * 32 != m * n
            or not keep_bits.is_contiguous() or keep_bits.device != device
            or keep_bits.data_ptr() % 16):
        raise ValueError(f"{what}: keep_bits {keep_bits.dtype} "
                         f"{tuple(keep_bits.shape)} on {keep_bits.device}, "
                         f"expected contiguous, 16-byte aligned int32 "
                         f"[{m * n // 32}] on {device}")


def gemm_dgrad(g: torch.Tensor, wt: torch.Tensor, keep_bits: torch.Tensor,
               scale: float, xyz=None) -> tuple:
    """The dgrad GEMM role, g [M, K] x W^T [N, K] (bf16, K = the layer's
    output width, N its input width) masked by the keep bits of h_prev [M,
    N] (as gemm_fwd(..., keep_bits=True) or layer0 wrote them) -> (g_prev
    [M, N] bf16, see gemm_dgrad_reference; its column partials f32 [M //
    128, (1 or 4) N], see column_partials_reference, the xyz-weighted sums
    when xyz [M, 3] bf16 is given): as gemm_fwd for devices and shapes."""
    if g.device.type == "cpu":
        out = gemm_dgrad_reference(g, wt, keep_bits, scale)
        return out, column_partials_reference(out, xyz)
    bn = _gemm_operands(g, wt, "gemm_dgrad")
    m, n = g.shape[0], wt.shape[0]
    _check_keep_bits(keep_bits, m, n, g.device, "gemm_dgrad")
    if xyz is not None and (xyz.dtype != torch.bfloat16
                            or tuple(xyz.shape) != (m, 3)
                            or not xyz.is_contiguous()
                            or xyz.device != g.device):
        raise ValueError("gemm_dgrad: xyz must be contiguous bf16 [M, 3] on "
                         "g's device")
    out = torch.empty(m, n, dtype=torch.bfloat16, device=g.device)
    part = torch.empty(m // TN_LAYOUT["bm"], (1 if xyz is None else 4) * n,
                       dtype=torch.float32, device=g.device)
    rc = _lib().ft_gemm_dgrad(
        g.data_ptr(), wt.data_ptr(), m, n, g.shape[1], bn,
        keep_bits.data_ptr(), _ptr(xyz), scale, out.data_ptr(),
        part.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream)
    ins = (g, wt, keep_bits) if xyz is None else (g, wt, keep_bits, xyz)
    profiling.launched("gemm_dgrad", rc, *ins, out, part,
                       flops=2 * m * n * g.shape[1],
                       nbytes=_nbytes(*ins, out, part))
    return out, part


def layer0_reference(xyz: torch.Tensor, rows: torch.Tensor,
                     wx: torch.Tensor, p: int, seed: int = 0,
                     rate: float = 0.0) -> torch.Tensor:
    """Plain version of the first layer (K = 3): bf16(drop(relu(rows[row
    // p] + xyz wx^T))) from bf16 xyz [M, 3] and wx [N, 3], f32 rows [M //
    p, N]; the dropout mask of `ops.relu_dropout` for layer seed `seed`."""
    acc = rows.float().repeat_interleave(p, 0) + xyz.float() @ wx.float().T
    a = torch.relu(acc)
    if rate > 0:
        keep = dropout_keep_mask(a.shape[0], a.shape[1], seed, rate,
                                 device=a.device)
        a = torch.where(keep, a * (1.0 / (1.0 - rate)), 0.0)
    return a.to(torch.bfloat16)


def layer0(xyz: torch.Tensor, rows: torch.Tensor, wx: torch.Tensor, p: int,
           seed: int = 0, rate: float = 0.0) -> tuple:
    """The first layer of the pass, (h_0 [M, N] bf16, its keep bits as
    gemm_fwd writes them) from xyz [M, 3] bf16, the per-scene rows [M //
    p, N] f32 (bias + latent term) and wx [N, 3] bf16: the plain version on
    CPU tensors, one launch of the kernel's layer-0 kernel on CUDA
    tensors (M and p multiples of 128, N of 128)."""
    m, n = xyz.shape[0], wx.shape[0]
    if xyz.device.type == "cpu":
        out = layer0_reference(xyz, rows, wx, p, seed, rate)
        return out, pack_keep_bits(out > 0)
    bn = check_shape(m, n, TN_LAYOUT["bk"])
    if (p <= 0 or p % TN_LAYOUT["bm"] or m % p
            or tuple(rows.shape) != (m // p, n)
            or rows.dtype != torch.float32
            or xyz.dtype != torch.bfloat16 or wx.dtype != torch.bfloat16
            or tuple(wx.shape) != (n, 3) or xyz.shape[1:] != (3,)
            or any(not t.is_contiguous() or t.device != xyz.device
                   for t in (rows, wx))):
        raise ValueError(f"layer0: xyz {xyz.dtype} {tuple(xyz.shape)}, rows "
                         f"{rows.dtype} {tuple(rows.shape)}, wx {wx.dtype} "
                         f"{tuple(wx.shape)}, {p} points a scene")
    xyz = xyz.contiguous()
    out = torch.empty(m, n, dtype=torch.bfloat16, device=xyz.device)
    bits = torch.empty(m * n // 32, dtype=torch.int32, device=xyz.device)
    drop = int(rate > 0)
    rc = _lib().ft_layer0(
        xyz.data_ptr(), rows.data_ptr(), wx.data_ptr(), out.data_ptr(),
        bits.data_ptr(), m, p, n, bn, seed & 0xFFFFFFFF,
        keep_threshold(rate), 1.0 / (1.0 - rate) if drop else 1.0, drop,
        torch.cuda.current_stream(xyz.device).cuda_stream)
    profiling.launched("layer0", rc, xyz, rows, wx, out,
                       flops=2 * m * n * 3,
                       nbytes=_nbytes(xyz, rows, wx, out, bits))
    return out, bits


def gemm_wgrad_reference(g: torch.Tensor, h: torch.Tensor,
                         k_split: int) -> torch.Tensor:
    """Plain version of the wgrad GEMM role: the f32 partials [K //
    k_split, M, N] of g^T h, chunk c summing points c k_split .. (c + 1)
    k_split - 1 of g [K, M] and h [K, N] (bf16 operands, f32 products and
    sums)."""
    c = g.shape[0] // k_split
    return torch.bmm(g.float().reshape(c, k_split, -1).transpose(1, 2),
                     h.float().reshape(c, k_split, -1))


def gemm_wgrad(g: torch.Tensor, h: torch.Tensor, k_split: int
               ) -> torch.Tensor:
    """The wgrad GEMM role, per-chunk partials [K // k_split, M, N] f32 of
    g [K, M]^T h [K, N] (bf16, K = the points, M the layer's output width,
    N its input width; see gemm_wgrad_reference): on any device the shapes
    are checked first (M a multiple of 128, N of 128, k_split a multiple of
    64 dividing K; contiguous, 16-byte aligned bf16 operands; raises
    otherwise), then the plain version runs on CPU tensors and one launch
    of the wgrad kernel on CUDA tensors. The caller sums the chunks in a
    fixed order."""
    for t in (g, h):
        if (t.dtype != torch.bfloat16 or t.ndim != 2 or not t.is_contiguous()
                or t.device != g.device or t.data_ptr() % 16):
            raise ValueError(f"gemm_wgrad: operands must be contiguous, "
                             f"16-byte aligned bf16 matrices on one device, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if g.shape[0] != h.shape[0]:
        raise ValueError(f"gemm_wgrad: K (points) of {tuple(g.shape)} and "
                         f"{tuple(h.shape)}")
    (k, m), n = g.shape, h.shape[1]
    bn = check_wgrad_shape(m, n, k, k_split)
    if g.device.type == "cpu":
        return gemm_wgrad_reference(g, h, k_split)
    part = torch.empty(k // k_split, m, n, dtype=torch.float32,
                       device=g.device)
    rc = _lib().ft_gemm_wgrad(
        g.data_ptr(), h.data_ptr(), m, n, k, k_split, bn, part.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    profiling.launched("gemm_wgrad", rc, g, h, part, flops=2 * m * n * k,
                       nbytes=_nbytes(g, h, part))
    return part


def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0])).contiguous()


def _nbytes(*tensors) -> int:
    return sum(t.nbytes for t in tensors)


def _reduce(part: torch.Tensor, n_out: int, n_sum: int, stream) -> torch.Tensor:
    """[n_out * n_sum, len] f32 -> [n_out, len], each sum in order."""
    length = part.shape[1]
    out = torch.empty(n_out, length, dtype=torch.float32, device=part.device)
    _call("ft_reduce", part.data_ptr(), out.data_ptr(), n_out, n_sum, length,
          length, stream)
    return out


def _sum_parts(part: torch.Tensor, stream) -> torch.Tensor:
    """[n, len] f32 -> [len]: a fixed-order sum, in two levels when n is
    large (a level sums groups of at most 128 consecutive rows)."""
    n = part.shape[0]
    while n > 128:
        d = next((d for d in range(128, 1, -1) if n % d == 0), None)
        if d is None:
            break
        part = _reduce(part, n // d, d, stream)
        n //= d
    return _reduce(part, 1, n, stream)[0]


def _fused_train_cuda(ew: EvalWeights, z, xyz, sdf, num_sdf_samples,
                      clamp_dist, rate, seed) -> tuple:
    S, P, _ = xyz.shape
    N = S * P
    L = ew.latent_size
    layers = ew.layers
    n_lin = len(layers)
    dev = z.device
    bf = torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv_n = 1.0 / num_sdf_samples
    scale = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    z = z.float().contiguous()
    xb = xyz.reshape(N, 3).to(bf).contiguous()
    sdf_f = sdf.reshape(N).float().contiguous()

    true_out = [lay.b.shape[0] for lay in layers]
    width = [_pad_to(w) for w in true_out[:-1]] + [1]
    w_h, w_z, w_x, bias = [], [], [], []
    for i, lay in enumerate(layers):
        k_in = width[i - 1] if i > 0 else 0
        w_h.append(None if lay.w_h is None
                   else _pad2(lay.w_h.to(bf), width[i], k_in))
        w_z.append(None if lay.w_z is None
                   else _pad2(lay.w_z.to(bf), width[i], L))
        w_x.append(None if lay.w_x is None
                   else _pad2(lay.w_x.to(bf), width[i], 3))
        bias.append(F.pad(lay.b.float(), (0, width[i] - true_out[i]))
                    .contiguous())

    # ---- forward: every hidden activation to device memory (bf16), and
    # the keep bits of each one a dgrad masks with (all but the last)
    rows = {}
    for i, lay in enumerate(layers):
        if lay.w_z is not None:
            rows[i] = torch.empty(S, width[i], dtype=torch.float32,
                                  device=dev)
            _call("ft_scene_rows", z.data_ptr(), w_z[i].data_ptr(),
                  bias[i].data_ptr(), rows[i].data_ptr(), S, L, width[i],
                  stream)
    h0, b0 = layer0(xb, rows[0], w_x[0], P, layer_seed(seed, 0), rate)
    hs, bits = [h0], [b0]
    for i in range(1, n_lin - 1):
        skip = layers[i].w_z is not None
        masked = i < n_lin - 2          # the final kernel reads h_last itself
        out = gemm_fwd(hs[-1], w_h[i], rows[i] if skip else bias[i][None], P,
                       xb if skip else None, w_x[i] if skip else None,
                       layer_seed(seed, i), rate, keep_bits=masked)
        h, b = out if masked else (out, None)
        hs.append(h)
        bits.append(b)

    # ---- final layer, loss, and its backward
    K = width[n_lin - 2]
    top_xyz = layers[n_lin - 2].w_x is not None
    nblk = N // FINAL_ROWS
    g = torch.empty(N, K, dtype=bf, device=dev)
    loss_part = torch.empty(nblk, 1, dtype=torch.float32, device=dev)
    db_part = torch.empty(nblk, 1, dtype=torch.float32, device=dev)
    dw_part = torch.empty(nblk, K, dtype=torch.float32, device=dev)
    part = torch.empty(nblk, (4 if top_xyz else 1) * K, dtype=torch.float32,
                       device=dev)
    w_last = w_h[-1].reshape(-1)
    _call("ft_final", hs[-1].data_ptr(), w_last.data_ptr(),
          bias[-1].data_ptr(), sdf_f.data_ptr(),
          xb.data_ptr() if top_xyz else None, g.data_ptr(),
          loss_part.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
          part.data_ptr(), N, K, clamp_dist, inv_n, scale, stream)
    loss = _sum_parts(loss_part, stream)[0] * inv_n
    in_last = layers[-1].w_h.shape[1]
    grads = [None] * n_lin
    grads[-1] = {"w_h": _sum_parts(dw_part, stream)[:in_last][None, :],
                 "b": _sum_parts(db_part, stream)}

    # ---- hidden layers, top down: g and its column partials (per tile of
    # FINAL_ROWS points from the final layer, of 128 from each dgrad; the
    # xyz-weighted sums only where the layer has w_x)
    dz = torch.zeros(S, L, dtype=torch.float32, device=dev)
    k_split = wgrad_chunk(N)
    for i in range(n_lin - 2, -1, -1):
        lay, wi, wt = layers[i], width[i], true_out[i]
        nsum = part.shape[1] // wi
        per_scene = _reduce(part, S, part.shape[0] // S, stream)
        tot = _sum_parts(per_scene, stream).reshape(nsum, wi)
        gr = {"b": tot[0, :wt]}
        if lay.w_z is not None:
            gsum = per_scene.reshape(S, nsum, wi)[:, 0].contiguous()
            gr["w_x"] = tot[1:4, :wt].T.contiguous()
            dwz = torch.empty(wi, L, dtype=torch.float32, device=dev)
            _call("ft_dwz", gsum.data_ptr(), z.data_ptr(), dwz.data_ptr(), S,
                  L, wi, stream)
            gr["w_z"] = dwz[:wt]
            _call("ft_dz", gsum.data_ptr(), w_z[i].data_ptr(), dz.data_ptr(),
                  S, L, wi, 1, stream)
        if i > 0:
            k_in = width[i - 1]
            part_w = gemm_wgrad(g, hs[i - 1], k_split)
            dw = _sum_parts(part_w.reshape(N // k_split, wi * k_in),
                            stream).reshape(wi, k_in)
            gr["w_h"] = dw[:wt, :lay.w_h.shape[1]]
            g, part = gemm_dgrad(g, w_h[i].t().contiguous(), bits[i - 1],
                                 scale,
                                 xb if layers[i - 1].w_x is not None else None)
        grads[i] = gr
    return loss, dz, grads


def fused_train_loss_grads(ew: EvalWeights, z: torch.Tensor,
                           xyz: torch.Tensor, sdf: torch.Tensor,
                           num_sdf_samples: int, clamp_dist: float,
                           dropout_rate: float, seed: int) -> tuple:
    """One fused forward + loss + backward pass over [S, P] points.

    Returns (loss_l1, dz [S, L], grads): grads[i] holds the f32 gradients
    of layer i's folded `w_h` / `w_z` / `w_x` / `b` (torch layout). The
    caller chains them through the weight-norm fold."""
    S, P, _ = xyz.shape
    if P % TN_LAYOUT["bm"]:
        raise ValueError(f"samples_per_scene {P} is not a multiple of the "
                         f"kernel's {TN_LAYOUT['bm']}-point tiles")
    if z.device.type == "cpu":
        return fused_train_reference(ew, z, xyz, sdf, num_sdf_samples,
                                     clamp_dist, dropout_rate, seed)
    if z.device.type != "cuda" or xyz.device != z.device \
            or sdf.device != z.device:
        raise ValueError(f"fused_train: inputs on {z.device}/{xyz.device}/"
                         f"{sdf.device}")
    la = ew.layers
    if (la[0].w_h is not None or la[-1].w_z is not None
            or la[-1].b.shape[0] != 1
            or any(lay.w_h is None for lay in la[1:])):
        raise ValueError("fused_train: unsupported layer plan")
    weights = [t for lay in la for t in lay if t is not None]
    profiling.check_kernel("fused_train", z, xyz, sdf, *weights)
    # z, xyz, sdf and the weights in; the loss, dz and f32 gradients out
    nbytes = _nbytes(z, xyz, sdf, *weights) + 4 * (
        1 + z.numel() + sum(t.numel() for t in weights))
    with profiling.kernel_pass("fused_train", train_flops(ew, S, P),
                               nbytes):
        out = _fused_train_cuda(ew, z, xyz, sdf, num_sdf_samples,
                                clamp_dist, dropout_rate, seed)
    profiling.launched("fused_train", 0, out[0], out[1],
                           *(t for gr in out[2] for t in gr.values()))
    return out


def _detached(ew: EvalWeights) -> EvalWeights:
    return EvalWeights(tuple(
        EvalLayer(*(None if t is None else t.detach() for t in lay))
        for lay in ew.layers), ew.use_tanh, ew.latent_size)


def make_fused_ad_loss_grads(decoder: SdfDecoder, cfg: AdConfig,
                             reg_scene_count: Optional[int] = None,
                             all_reduce: Optional[Callable] = None
                             ) -> Callable:
    """value_and_grads(codes, scene_ids, xyz, sdf, epoch, seed) ->
    (loss, aux): runs the fused pass and leaves the gradients in the
    `.grad` of the decoder's parameters and of `codes` (a dense leaf
    tensor), as `loss.backward()` does on the autograd route.

    Data parallelism (parallel/dp.py): `reg_scene_count` normalises the
    code-reg term (default: the local batch's scene count; a shard passes
    the global `cfg.scenes_per_batch`; the clamped-L1 term already
    divides by the global S x P), and `all_reduce(tensors)` sums a list
    of f32 tensors over the ranks in place. It gets the loss terms, the
    dense code gradient and the folded-weight gradients, before the
    fold's chain rounds them to the weights' bf16, so a shard's step
    rounds the global sum as one device does."""
    if cfg.code_bound not in (0, 0.0):
        raise NotImplementedError(
            "code_bound > 0 under use_pallas: the fused route does not "
            "chain gradients through the max-norm projection")
    if cfg.decoder.use_tanh:
        raise NotImplementedError("use_tanh under use_pallas: the fused "
                                  "train kernel has no tanh")
    N = cfg.scenes_per_batch * cfg.samples_per_scene
    rate = cfg.decoder.dropout_prob if cfg.decoder.use_dropout else 0.0

    def value_and_grads(codes, scene_ids, xyz, sdf, epoch, seed):
        params = dict(decoder.named_parameters())
        with torch.enable_grad():
            ew = precompute_eval_weights(decoder, params, torch.bfloat16)
        with torch.no_grad():
            z = gather_codes(codes.detach(), scene_ids)
            l1, dz, g_folded = fused_train_loss_grads(
                _detached(ew), z, xyz, sdf, N, cfg.clamp_dist, rate, seed)
        with torch.enable_grad():
            zr = gather_codes(codes, scene_ids)
            reg = losses.code_reg(zr, epoch, cfg.code_reg_lambda,
                                  cfg.code_reg_warmup_epochs,
                                  num_sdf_samples=(reg_scene_count
                                                   or zr.shape[0]),
                                  squared=cfg.code_reg_squared)
            reg.backward()
        codes.grad.index_add_(0, scene_ids, dz)
        reg = reg.detach()
        if all_reduce is not None:
            all_reduce([l1, reg, codes.grad,
                        *(gr[k] for gr in g_folded for k in gr)])
        tensors, cotangents = [], []
        for lay, gr in zip(ew.layers, g_folded):
            for k in _KEYS:
                t = getattr(lay, k)
                if t is not None:
                    tensors.append(t)
                    cotangents.append(gr[k].to(t.dtype))
        torch.autograd.backward(tensors, cotangents)
        return l1 + reg, {"loss_l1": l1, "loss_reg": reg}

    return value_and_grads
