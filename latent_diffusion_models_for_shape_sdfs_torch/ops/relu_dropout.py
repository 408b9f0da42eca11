"""Fused relu + inverted dropout for training (kernels #3 and #3b).

Counterpart of `relu_dropout` in the JAX package's `ops/pallas_kernels.py`
(`_relu_dropout_kernel` forward, `_mask_kernel` backward), ported to
`csrc/relu_dropout.cu`:

    y  = where(keep & (x > 0), x * scale, 0)       scale = 1/(1-rate) in x's type
    dx = where(keep & (x > 0), g * scale, 0)       g cast to x's type

An element is kept iff its 32-bit word >= min(rate * 2^32, 2^32 - 1). The
TPU draws the words from its hardware PRNG, which cannot be reproduced
(SEMANTICS.md section 7 keeps the semantics, not the bit streams); the
port draws them from a stateless Philox4x32-10 keyed by the seed and
counted by (row, column) only (`csrc/philox.cuh`). `dropout_keep_bits` is
that generator in torch integer ops, so the kernels and their plain
versions (`relu_dropout_reference`, `relu_dropout_bwd_reference`) give
the same mask bit for bit, and the fused train kernel (csrc/fused_train.cu)
draws the same mask for the same layer seed.

`relu_dropout` is a `torch.autograd.Function`: the backward regenerates the
mask from the seed and stores none. The bf16 decoder's hidden layers take
the kernels' layer entries instead (`ops.bf16_linear.bf16_linear_relu_dropout`):
`bias_relu_dropout_fwd` reads the layer's fp32 product and its bias and
rounds once, h = bf16(yf + b), out = where(keep & (h > 0), h * scale, 0);
`relu_dropout_bwd_out` reads that output and the bf16 cotangent and writes
gb = where(out > 0, g * scale, 0) and db, gb's fp32 column sums. out > 0
iff keep & (h > 0) at every rate in [0, 1), so gb is the masked cotangent
bit for bit with no mask drawn and no pre-activation kept. The kernel sums
db in a fixed order (`bwd_plan`, `db_kernel_order`); the plain version
with torch's `sum`.

On a CPU tensor each wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Each launch reports to `utils.profiling`'s
record (`launched`) as "relu_dropout_fwd" or "relu_dropout_bwd" (the
layer entries under the same two names): no FLOPs (its plain version's
elementwise ops count none), its input and output bytes, and the NaN
check of both.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_CHUNK_ROWS = 1 << 16   # rows per pass of the torch generator (memory)

# csrc/relu_dropout.cu's constants (checked against the kernel at load)
_THREADS = 256          # threads a CTA
_TILE_ROWS = 32         # tile path: rows a tile, fewer where they do not fit
_SMEM_MAX = 227 * 1024  # a CTA's dynamic shared memory
_RED_SLICES = 32        # db: slices of each column's partials
_RED_BLOCK = 16         # ... each summed in blocks of 16
# the backward-from-output's plan (passed to the kernel)
_BWD_ROWS = 64          # row path: rows a tile
_BWD_CTAS = 4 * 132     # the fixed grid: 4 CTAs on each of an H100's SMs


def layer_seed(seed: int, layer: int) -> int:
    """seed + 7919 * layer, wrapped to int32 (the JAX decoder's per-layer
    seed, models/decoder.py)."""
    return (int(seed) + 7919 * int(layer) + (1 << 31)) % (1 << 32) - (1 << 31)


def keep_threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _mulhilo(a: int, b: torch.Tensor) -> tuple:
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant a and int64
    tensor b holding uint32 values, without leaving int64 range."""
    p_lo = a * (b & 0xFFFF)                       # < 2^48
    p_hi = a * (b >> 16)                          # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)          # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c: list, key: tuple) -> list:
    """Philox4x32-10 on int64 tensors holding uint32 counters c[0..3] with
    key (k0, k1) python ints; returns the four output words."""
    c0, c1, c2, c3 = c
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return [c0, c1, c2, c3]


def dropout_keep_bits(n_rows: int, n_cols: int, seed: int, row0: int = 0,
                      device="cpu") -> torch.Tensor:
    """int64 [n_rows, n_cols] of uint32 words for rows row0.. row0+n_rows:
    element (r, c) is word c % 4 of Philox4x32-10 with counter
    (c // 4, r mod 2^32, r >> 32, 0) and key (seed mod 2^32, 0)."""
    groups = (n_cols + 3) // 4
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                        device=device)[:, None].expand(n_rows, groups)
    grp = torch.arange(groups, dtype=torch.int64,
                       device=device)[None, :].expand(n_rows, groups)
    words = philox4x32_10([grp, rows & _MASK32, rows >> 32,
                           torch.zeros_like(rows)], (int(seed), 0))
    return torch.stack(words, dim=-1).reshape(n_rows, 4 * groups)[:, :n_cols]


def dropout_keep_mask(n_rows: int, n_cols: int, seed: int, rate: float,
                      row0: int = 0, device="cpu") -> torch.Tensor:
    """bool [n_rows, n_cols]: keep iff the word >= keep_threshold(rate)."""
    thr = keep_threshold(rate)
    out = torch.empty(n_rows, n_cols, dtype=torch.bool, device=device)
    for r in range(0, n_rows, _CHUNK_ROWS):
        n = min(_CHUNK_ROWS, n_rows - r)
        out[r:r + n] = dropout_keep_bits(n, n_cols, seed, row0 + r,
                                         device) >= thr
    return out


def _scale(rate: float, dtype) -> torch.Tensor:
    return torch.tensor(1.0 / (1.0 - rate), dtype=dtype)


def relu_dropout_reference(x: torch.Tensor, seed: int,
                           rate: float) -> torch.Tensor:
    """Plain version of kernel #3 on x [..., H]."""
    x2d = x.reshape(-1, x.shape[-1])
    keep = dropout_keep_mask(x2d.shape[0], x2d.shape[1], seed, rate,
                             device=x.device)
    scale = _scale(rate, x.dtype).to(x.device)
    out = torch.where(keep & (x2d.float() > 0), x2d * scale,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return out.reshape(x.shape)


def relu_dropout_bwd_reference(x: torch.Tensor, g: torch.Tensor, seed: int,
                               rate: float) -> torch.Tensor:
    """Plain version of kernel #3b: the gradient of relu_dropout at x."""
    x2d = x.reshape(-1, x.shape[-1])
    g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
    keep = dropout_keep_mask(x2d.shape[0], x2d.shape[1], seed, rate,
                             device=x.device)
    scale = _scale(rate, x.dtype).to(x.device)
    dx = torch.where(keep & (x2d.float() > 0), g2d * scale,
                     torch.zeros((), dtype=x.dtype, device=x.device))
    return dx.reshape(x.shape)


def bias_relu_dropout_reference(yf: torch.Tensor, b: torch.Tensor, seed: int,
                                rate: float) -> torch.Tensor:
    """Plain version of kernel #3's layer entry: relu_dropout_reference of
    bf16(yf + b), the fp32 product plus its fp32 bias rounded once."""
    return relu_dropout_reference((yf + b).to(torch.bfloat16), seed, rate)


def relu_dropout_bwd_out_reference(out: torch.Tensor, g: torch.Tensor,
                                   rate: float) -> tuple:
    """Plain version of kernel #3b's layer entry: (gb, db) with gb =
    where(out > 0, bf16(g * scale), 0) in bf16 and db = gb's fp32 column
    sums over every row of the [..., H] view."""
    out2d = out.reshape(-1, out.shape[-1])
    g2d = g.reshape(-1, g.shape[-1]).to(torch.bfloat16)
    scale = _scale(rate, torch.bfloat16).to(out.device)
    gb = torch.where(out2d.float() > 0, g2d * scale,
                     torch.zeros((), dtype=torch.bfloat16, device=out.device))
    return gb.reshape(out.shape), gb.float().sum(0)


class BwdPlan(NamedTuple):
    """How kernel #3b's layer entry splits [rows, cols]: `vec` the row path
    (16-byte rows of 8 columns) or the tile path (shared memory),
    `tile_rows` rows a tile, `lanes` threads sharing a column (row path;
    1 on the tile path), `ctas` the fixed grid; CTA b takes tiles b,
    b + ctas, ..."""
    vec: bool
    tile_rows: int
    lanes: int
    ctas: int


def _region(cap: int, itemsize: int) -> int:
    """Bytes of a shared-memory buffer of `cap` elements (csrc `region`)."""
    return (cap * itemsize + 31) & ~15


def bwd_plan(rows: int, cols: int, aligned: bool = True) -> BwdPlan:
    """The plan of kernel #3b's layer entry for [rows, cols] (rows > 0);
    `aligned`: out, g and gb start on 16 bytes. The row path takes widths
    that are multiples of 8 up to 2,048, the tile path every other width
    whose 8-row tile fits shared memory."""
    chunks = cols // 8
    if aligned and cols % 8 == 0 and chunks <= _THREADS:
        tile_rows = _BWD_ROWS
        lanes = min(_THREADS // chunks, tile_rows)
        vec = True
    else:
        tile_rows = next((r for r in range(_TILE_ROWS, 0, -8)
                          if 2 * _region(r * cols, 2) + 4 * cols
                          <= _SMEM_MAX), 0)
        if tile_rows == 0:
            raise ValueError(f"relu_dropout_bwd_out: rows of {cols} do not "
                             "fit a tile of 8 in shared memory")
        lanes, vec = 1, False
    tiles = -(-rows // tile_rows)
    return BwdPlan(vec, tile_rows, lanes, min(tiles, _BWD_CTAS))


def db_kernel_order(gb: torch.Tensor, plan: BwdPlan) -> torch.Tensor:
    """db as kernel #3b's layer entry sums it, in fp32, for gb [rows, cols]
    and the plan it ran with: in each tile, lane l adds rows l, l + lanes,
    ... in order; each CTA adds its tiles' lane sums in tile order, then
    its lanes in order (one partial row); the partials of a column are cut
    into _RED_SLICES contiguous slices, each summed in blocks of
    _RED_BLOCK, and the slices pairwise (s += s + w for w = 16, ..., 1).
    Zeros pad every ragged end: +0 added to a sum that started at +0 moves
    no bit. The kernel's db equals this bit for bit."""
    rows, cols = gb.shape
    x = gb.float()
    R, L, G = plan.tile_rows, plan.lanes, plan.ctas
    tiles = -(-rows // R)
    K = -(-tiles // G)                      # tiles a CTA
    J = -(-R // L)                          # rows a lane, in a tile
    x = torch.cat([x, x.new_zeros(K * G * R - rows, cols)])
    x = x.reshape(K, G, R, cols)
    x = torch.cat([x, x.new_zeros(K, G, J * L - R, cols)], dim=2)
    x = x.reshape(K, G, J, L, cols)
    outer = x.new_zeros(G, L, cols)
    for k in range(K):
        inner = x.new_zeros(G, L, cols)
        for j in range(J):
            inner = inner + x[k, :, j]
        outer = outer + inner
    part = outer[:, 0]
    for lane in range(1, L):
        part = part + outer[:, lane]
    per = -(-G // _RED_SLICES)
    p = torch.cat([part, part.new_zeros(_RED_SLICES * per - G, cols)])
    p = p.reshape(_RED_SLICES, per, cols)
    sl = p.new_zeros(_RED_SLICES, cols)
    for i0 in range(0, per, _RED_BLOCK):
        inner = p.new_zeros(_RED_SLICES, cols)
        for i in range(i0, min(i0 + _RED_BLOCK, per)):
            inner = inner + p[:, i]
        sl = sl + inner
    w = _RED_SLICES // 2
    while w >= 1:
        sl = torch.cat([sl[:w] + sl[w:2 * w], sl[w:]])
        w //= 2
    return sl[0]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("relu_dropout.cu")
    if not getattr(lib, "_argtypes_set", False):
        vp, u32 = ctypes.c_void_p, ctypes.c_uint32
        lib.relu_dropout_fwd_launch.restype = ctypes.c_int
        lib.relu_dropout_fwd_launch.argtypes = [
            vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, u32, u32,
            ctypes.c_float, vp]
        lib.relu_dropout_bwd_launch.restype = ctypes.c_int
        lib.relu_dropout_bwd_launch.argtypes = [
            vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, u32,
            u32, ctypes.c_float, vp]
        lib.bias_relu_dropout_fwd_launch.restype = ctypes.c_int
        lib.bias_relu_dropout_fwd_launch.argtypes = [
            vp, vp, vp, ctypes.c_longlong, ctypes.c_int, u32, u32,
            ctypes.c_float, vp]
        i32 = ctypes.c_int
        lib.relu_dropout_bwd_out_launch.restype = i32
        lib.relu_dropout_bwd_out_launch.argtypes = [
            vp, vp, vp, vp, vp, ctypes.c_longlong, i32, ctypes.c_float, i32,
            i32, i32, i32, vp]
        got = (ctypes.c_int * 5)()
        lib.relu_dropout_constants(got)
        want = (_THREADS, _TILE_ROWS, _SMEM_MAX, _RED_SLICES, _RED_BLOCK)
        if tuple(got) != want:
            raise RuntimeError(f"relu_dropout.cu's constants {tuple(got)} "
                               f"differ from the wrapper's {want}")
        lib._argtypes_set = True
    return lib


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"relu_dropout: tensor on {x.device}; the kernel "
                         "takes CUDA tensors, the plain version CPU ones")
    if x.dtype not in _DTYPES:
        raise ValueError(f"relu_dropout: dtype {x.dtype} not supported "
                         "(float32, bfloat16)")


def relu_dropout_fwd(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Forward of relu_dropout without autograd: plain version on the CPU,
    kernel #3 on the card."""
    if x.device.type == "cpu":
        return relu_dropout_reference(x, seed, rate)
    _check_cuda(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = _lib().relu_dropout_fwd_launch(
        x.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1], x.shape[-1],
        _DTYPES[x.dtype], int(seed) & 0xFFFFFFFF, keep_threshold(rate),
        float(_scale(rate, x.dtype)),
        torch.cuda.current_stream(x.device).cuda_stream)
    profiling.launched("relu_dropout_fwd", rc, x, out, nbytes=2 * x.nbytes)
    return out


def relu_dropout_bwd(x: torch.Tensor, g: torch.Tensor, seed: int,
                     rate: float) -> torch.Tensor:
    """Backward of relu_dropout: plain version on the CPU, kernel #3b on
    the card."""
    if x.device.type == "cpu":
        return relu_dropout_bwd_reference(x, g, seed, rate)
    _check_cuda(x)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"relu_dropout_bwd: g {tuple(g.shape)} on "
                         f"{g.device}, x {tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    rc = _lib().relu_dropout_bwd_launch(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel() // x.shape[-1],
        x.shape[-1], _DTYPES[x.dtype], int(seed) & 0xFFFFFFFF,
        keep_threshold(rate), float(_scale(rate, x.dtype)),
        torch.cuda.current_stream(x.device).cuda_stream)
    profiling.launched("relu_dropout_bwd", rc, x, g, dx, nbytes=3 * x.nbytes)
    return dx


def _check_layer(name: str, want: dict, **tensors) -> None:
    """Dtype of each named tensor (`want`), and on the card: every tensor
    a contiguous CUDA tensor on one device."""
    for k, t in tensors.items():
        if t.dtype != want[k]:
            raise ValueError(f"{name}: {k} is {t.dtype}, not {want[k]}")
    first = next(iter(tensors.values()))
    if first.device.type == "cpu":
        return
    for k, t in tensors.items():
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {k} on {t.device}; the kernel takes "
                             f"CUDA tensors on one device, the plain "
                             f"version CPU ones")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")


def bias_relu_dropout_fwd(yf: torch.Tensor, b: torch.Tensor, seed: int,
                          rate: float) -> torch.Tensor:
    """Kernel #3's layer entry: yf [..., H] fp32 (a product without its
    bias), b [H] fp32 -> bf16 [..., H], relu + dropout of bf16(yf + b).
    Plain version on the CPU, the kernel on the card."""
    _check_layer("bias_relu_dropout_fwd",
                 {"yf": torch.float32, "b": torch.float32}, yf=yf, b=b)
    if b.shape != yf.shape[-1:]:
        raise ValueError(f"bias_relu_dropout_fwd: b {tuple(b.shape)} for "
                         f"yf {tuple(yf.shape)}")
    if yf.device.type == "cpu":
        return bias_relu_dropout_reference(yf, b, seed, rate)
    out = torch.empty(yf.shape, dtype=torch.bfloat16, device=yf.device)
    rc = _lib().bias_relu_dropout_fwd_launch(
        yf.data_ptr(), b.data_ptr(), out.data_ptr(),
        yf.numel() // yf.shape[-1], yf.shape[-1], int(seed) & 0xFFFFFFFF,
        keep_threshold(rate), float(_scale(rate, torch.bfloat16)),
        torch.cuda.current_stream(yf.device).cuda_stream)
    profiling.launched("relu_dropout_fwd", rc, yf, b, out,
                       nbytes=yf.nbytes + b.nbytes + out.nbytes)
    return out


def relu_dropout_bwd_out(out: torch.Tensor, g: torch.Tensor,
                         rate: float) -> tuple:
    """Kernel #3b's layer entry: out (the forward's output) and g, both
    bf16 [..., H] -> (gb bf16 [..., H], db fp32 [H]), gb = where(out > 0,
    bf16(g * scale), 0) and db its column sums. Plain version on the CPU;
    on the card the kernel, whose db is summed in `db_kernel_order`."""
    _check_layer("relu_dropout_bwd_out",
                 {"out": torch.bfloat16, "g": torch.bfloat16}, out=out, g=g)
    if g.shape != out.shape:
        raise ValueError(f"relu_dropout_bwd_out: g {tuple(g.shape)}, out "
                         f"{tuple(out.shape)}")
    if out.device.type == "cpu":
        return relu_dropout_bwd_out_reference(out, g, rate)
    cols = out.shape[-1]
    rows = out.numel() // cols
    gb = torch.empty_like(out)
    db = torch.zeros(cols, dtype=torch.float32, device=out.device)
    if rows == 0:
        return gb, db
    plan = bwd_plan(rows, cols, all(t.data_ptr() % 16 == 0
                                    for t in (out, g, gb)))
    partials = torch.empty(plan.ctas, cols, dtype=torch.float32,
                           device=out.device)
    rc = _lib().relu_dropout_bwd_out_launch(
        out.data_ptr(), g.data_ptr(), gb.data_ptr(), partials.data_ptr(),
        db.data_ptr(), rows, cols, float(_scale(rate, torch.bfloat16)),
        int(plan.vec), plan.tile_rows, plan.lanes, plan.ctas,
        torch.cuda.current_stream(out.device).cuda_stream)
    profiling.launched("relu_dropout_bwd", rc, out, g, gb, db,
                       nbytes=out.nbytes + g.nbytes + gb.nbytes + db.nbytes)
    return gb, db


class _ReluDropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(x)
        ctx.seed, ctx.rate = seed, rate
        return relu_dropout_fwd(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return relu_dropout_bwd(x, g, ctx.seed, ctx.rate), None, None


def relu_dropout(x: torch.Tensor, seed: int, rate: float = 0.2
                 ) -> torch.Tensor:
    """dropout(relu(x)) with inverted-dropout scaling, x [..., H]; the
    mask of element (row, col) of the flattened [rows, H] view depends on
    (seed, row, col) only. Deterministic given the seed."""
    return _ReluDropout.apply(x, int(seed), float(rate))
