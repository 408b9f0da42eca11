"""Set-to-set metrics on the device: pairwise Chamfer and Sinkhorn-EMD.

Counterpart of the JAX package's `evaluation/device_metrics.py`. The host
path (evaluation.generative) computes the G x R Chamfer matrix with
per-pair KD-trees; here every pair is |a|^2 + |b|^2 - 2 a.b^T (one
batched fp32 product with TF32 off, as the reference asks for full-f32
passes), then row/column minima, for `chunk` pairs at a time.

EMD uses entropically-regularized optimal transport (Sinkhorn, log
domain) on the UNSQUARED L2 cost, the convention of the point-cloud
generative-metric literature (Achlioptas et al. 2018), where EMD(A,B) is
the mean matched distance under an optimal 1-1 assignment; the exact
assignment (evaluation.generative.emd_exact) is its oracle.

All functions take float32 [S, n, 3] stacked clouds (equal sizes: the
samplers produce fixed-size clouds) and return host floats / NumPy
arrays. The pairs run in chunks of `chunk`, enqueued without a host wait;
the matrix is read once at the end. Peak memory is about
chunk * n * m * 4 bytes times the few temporaries alive at once (the
cost, its logsumexp argument and exponent for EMD).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)


@contextlib.contextmanager
def _full_fp32():
    """fp32 products without TF32 (the reference's Precision.HIGHEST)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean [B, n, m] between [B, n, 3] and [B, m, 3] clouds,
    in the expanded form (fine at cloud scale: coords in [-1,1], so the
    cancellation is bounded); tiny negatives from rounding are clamped
    before the sqrt of EMD."""
    aa = torch.sum(a * a, dim=-1)
    bb = torch.sum(b * b, dim=-1)
    ab = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp(aa[:, :, None] + bb[:, None, :] - 2.0 * ab, min=0.0)


def _chamfer_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Chamfer-L2 of each pair of a batch [B, n, 3] x [B, m, 3] -> [B]."""
    d2 = _dist2(a, b)
    return (torch.mean(torch.amin(d2, dim=2), dim=1)
            + torch.mean(torch.amin(d2, dim=1), dim=1))


def _sinkhorn_pair(a: torch.Tensor, b: torch.Tensor, eps: float,
                   iters: int) -> torch.Tensor:
    """Entropic-OT mean matched L2 distance of each pair of a batch of
    equal-size clouds [B, n, 3] x [B, n, 3] -> [B]."""
    n = a.shape[1]
    c = torch.sqrt(_dist2(a, b))                   # unsquared L2 cost
    # log-domain Sinkhorn, uniform marginals 1/n
    f = torch.zeros(a.shape[:2], dtype=torch.float32, device=a.device)
    g = torch.zeros_like(f)
    loga = -math.log(n)
    for _ in range(iters):
        # row constraint sum_j P_ij = 1/n with P = a b exp((f+g-c)/eps)
        # => f_i = -eps * (logsumexp_j((g_j - c_ij)/eps) + log(1/n))
        f = -eps * (torch.logsumexp((g[:, None, :] - c) / eps, dim=2)
                    + loga)
        g = -eps * (torch.logsumexp((f[:, :, None] - c) / eps, dim=1)
                    + loga)
    # transport plan in log space; <P, C> = mean matched distance
    logp = (f[:, :, None] + g[:, None, :] - c) / eps + 2 * loga
    return torch.sum(torch.exp(logp) * c, dim=(1, 2))


def _pairs_metric(xa: torch.Tensor, xb: torch.Tensor, pair: np.ndarray,
                  metric: str, chunk: int, eps: float,
                  iters: int) -> np.ndarray:
    """The metric over an explicit [P, 2] pair list, `chunk` pairs a step
    (the last padded with its edge pair) -> [P] host float32."""
    total = len(pair)
    nchunks = math.ceil(total / chunk)
    pair = np.pad(pair, ((0, nchunks * chunk - total), (0, 0)), mode="edge")
    idx = torch.as_tensor(pair, dtype=torch.long, device=xa.device)
    out = torch.empty(nchunks * chunk, dtype=torch.float32, device=xa.device)
    with _full_fp32():
        for s in range(0, nchunks * chunk, chunk):
            a = xa.index_select(0, idx[s:s + chunk, 0])
            b = xb.index_select(0, idx[s:s + chunk, 1])
            out[s:s + chunk] = (_chamfer_pair(a, b) if metric == "chamfer"
                                else _sinkhorn_pair(a, b, eps, iters))
    return out[:total].cpu().numpy()


def _stack(clouds, device) -> torch.Tensor:
    if isinstance(clouds, torch.Tensor):
        return clouds.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.stack(clouds).astype(np.float32),
                           device=device)


def pairwise_metric(set_a, set_b, metric: str = "chamfer",
                    chunk: int = 4, eps: float = 0.01, iters: int = 200,
                    device="cuda") -> np.ndarray:
    """[len(a), len(b)] matrix of Chamfer-L2 or Sinkhorn-EMD on `device`.

    set_a/set_b: lists (or [S, n, 3] arrays or tensors) of equal-size
    clouds. chunk: pairs evaluated together; peak memory ~ chunk * n * m
    * 4 bytes times the temporaries alive at once."""
    if metric not in ("chamfer", "emd"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = resolve_device(device)
    xa, xb = _stack(set_a, dev), _stack(set_b, dev)
    if metric == "emd" and xa.shape[1] != xb.shape[1]:
        raise ValueError("EMD needs equal-size clouds (1-1 matching)")
    S_a, S_b = int(xa.shape[0]), int(xb.shape[0])
    pair = np.stack(np.meshgrid(np.arange(S_a), np.arange(S_b),
                                indexing="ij"), -1).reshape(-1, 2)
    return _pairs_metric(xa, xb, pair, metric, chunk, eps,
                         iters).reshape(S_a, S_b)


def pairwise_metric_self(set_x, metric: str = "chamfer", chunk: int = 4,
                         eps: float = 0.01, iters: int = 200,
                         device="cuda") -> np.ndarray:
    """Symmetric within-set matrix (float64, zero diagonal): evaluates
    only the i<j triangle (both metrics are symmetric in their
    arguments) and mirrors it."""
    dev = resolve_device(device)
    xx = _stack(set_x, dev)
    S = int(xx.shape[0])
    iu, ju = np.triu_indices(S, k=1)
    out = np.zeros((S, S), np.float64)
    if len(iu):
        flat = _pairs_metric(xx, xx, np.stack([iu, ju], -1), metric, chunk,
                             eps, iters)
        out[iu, ju] = flat
        out[ju, iu] = flat
    return out


def evaluate_generated_device(gen_points, ref_points,
                              metrics=("chamfer",), chunk: int = 4,
                              eps: float = 0.01, iters: int = 200,
                              device="cuda") -> dict:
    """MMD / COV / 1-NNA over device-computed distance matrices.

    Same definitions and keys as the reference: Chamfer gives
    mmd_chamfer, coverage, one_nna; "emd" adds mmd_emd, coverage_emd,
    one_nna_emd (evaluation.generative is the host oracle)."""
    out = {}
    for metric in metrics:
        d_gr = pairwise_metric(gen_points, ref_points, metric, chunk, eps,
                               iters, device=device)             # [G, R]
        suffix = "chamfer" if metric == "chamfer" else "emd"
        out[f"mmd_{suffix}"] = float(d_gr.min(axis=0).mean())
        out[f"coverage_{suffix}" if metric != "chamfer" else "coverage"] \
            = float(len(np.unique(d_gr.argmin(axis=1))) / d_gr.shape[1])
        # 1-NNA needs within-set distances too (triangle-only, mirrored)
        d_gg = pairwise_metric_self(gen_points, metric, chunk, eps, iters,
                                    device=device)
        d_rr = pairwise_metric_self(ref_points, metric, chunk, eps, iters,
                                    device=device)
        G, R = d_gr.shape
        d = np.block([[d_gg, d_gr], [d_gr.T, d_rr]])
        np.fill_diagonal(d, np.inf)
        labels = np.array([0] * G + [1] * R)
        nn = d.argmin(axis=1)
        out[f"one_nna_{suffix}" if metric != "chamfer" else "one_nna"] \
            = float((labels[nn] == labels).mean())
    return out
