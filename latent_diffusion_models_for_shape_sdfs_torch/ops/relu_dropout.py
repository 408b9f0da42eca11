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
mask from the seed and stores none. On a CPU tensor it runs the plain
version; on a CUDA tensor it launches the kernel or raises. `LAUNCHES`
counts kernel launches. Each launch reports to `utils.profiling`'s hooks:
no FLOPs (its plain version's elementwise ops count none), its input and
output bytes, and the NaN check of both.
"""

from __future__ import annotations

import ctypes

import torch

from latent_diffusion_models_for_shape_sdfs_torch.ops import _build
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling

LAUNCHES = {"relu_dropout_fwd": 0, "relu_dropout_bwd": 0}

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_CHUNK_ROWS = 1 << 16   # rows per pass of the torch generator (memory)


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
    if rc != 0:
        raise RuntimeError(f"relu_dropout_fwd_launch failed: cudaError {rc}")
    LAUNCHES["relu_dropout_fwd"] += 1
    profiling.check_kernel("relu_dropout_fwd", x, out)
    profiling.count_kernel("relu_dropout_fwd", 0, 2 * x.nbytes)
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
    if rc != 0:
        raise RuntimeError(f"relu_dropout_bwd_launch failed: cudaError {rc}")
    LAUNCHES["relu_dropout_bwd"] += 1
    profiling.check_kernel("relu_dropout_bwd", x, g, dx)
    profiling.count_kernel("relu_dropout_bwd", 0, 3 * x.nbytes)
    return dx


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
