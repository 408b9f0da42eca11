"""Generative-set evaluation: MMD / Coverage / 1-NNA over Chamfer-L2.

The standard point-cloud generative metrics (Achlioptas et al. 2018;
used by the latent-shape-diffusion literature the reference sits in):

  - MMD (minimum matching distance): for each reference shape, the
    Chamfer distance to its nearest generated shape — fidelity.
  - COV (coverage): fraction of reference shapes that are the nearest
    neighbour of at least one generated shape — mode coverage.
  - 1-NNA (1-nearest-neighbour accuracy): leave-one-out classification
    accuracy of a 1-NN classifier separating generated from reference
    sets; 50% = indistinguishable (ideal), 100% = trivially separable.

All host-side NumPy/scipy over surface point clouds (sampled with
evaluation.mesh_sample / data.analytic.sample_surface): the port's copy of
the JAX package's `evaluation/generative.py`, and the oracle that
evaluation.device_metrics is held against.
"""

from __future__ import annotations

import numpy as np

from latent_diffusion_models_for_shape_sdfs_torch.evaluation.chamfer import (
    chamfer_l2)


def pairwise_chamfer(set_a: list, set_b: list) -> np.ndarray:
    """Chamfer-L2 matrix [len(a), len(b)] between point-cloud lists."""
    out = np.empty((len(set_a), len(set_b)), np.float64)
    for i, a in enumerate(set_a):
        for j, b in enumerate(set_b):
            out[i, j] = chamfer_l2(a, b)
    return out


def mmd_coverage(gen_points: list, ref_points: list) -> dict:
    """MMD + COV of a generated set against a reference set."""
    d = pairwise_chamfer(gen_points, ref_points)  # [G, R]
    mmd = float(d.min(axis=0).mean())             # per-ref nearest gen
    cov = float(len(np.unique(d.argmin(axis=1))) / d.shape[1])
    return {"mmd_chamfer": mmd, "coverage": cov}


def one_nna(gen_points: list, ref_points: list) -> float:
    """1-NN accuracy between the two sets (0.5 is ideal)."""
    pts = list(gen_points) + list(ref_points)
    labels = np.array([0] * len(gen_points) + [1] * len(ref_points))
    n = len(pts)
    d = np.zeros((n, n), np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            d[i, j] = d[j, i] = chamfer_l2(pts[i], pts[j])
    np.fill_diagonal(d, np.inf)
    nn = d.argmin(axis=1)
    return float((labels[nn] == labels).mean())


def evaluate_generated(gen_points: list, ref_points: list) -> dict:
    out = mmd_coverage(gen_points, ref_points)
    out["one_nna"] = one_nna(gen_points, ref_points)
    return out


def emd_exact(a: np.ndarray, b: np.ndarray) -> float:
    """Exact EMD between equal-size clouds: mean matched L2 distance
    under the optimal 1-1 assignment (scipy Hungarian). O(n^3) — use
    small clouds (<=512 points); the oracle for the device Sinkhorn."""
    from scipy.optimize import linear_sum_assignment
    c = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    r, cidx = linear_sum_assignment(c)
    return float(c[r, cidx].mean())


def evaluate_generated_emd_host(gen_points: list, ref_points: list,
                                points: int = 512, seed: int = 0) -> dict:
    """MMD/COV/1-NNA under EXACT EMD, host-side, on subsampled clouds.

    The oracle of the device Sinkhorn path (one Hungarian solve per
    pair, O(points^3)). Subsampling is the standard practice for EMD
    benchmarks (the metric is far more assignment-cost-bound than
    Chamfer); results are labeled with the cloud size used.
    """
    rng = np.random.default_rng(seed)

    def sub(c):
        c = np.asarray(c)
        if len(c) <= points:
            return c
        return c[rng.choice(len(c), points, replace=False)]

    gen = [sub(c) for c in gen_points]
    ref = [sub(c) for c in ref_points]

    def matrix(A, B, symmetric=False):
        d = np.zeros((len(A), len(B)))
        for i, a in enumerate(A):
            for j, b in enumerate(B):
                if symmetric and j < i:
                    d[i, j] = d[j, i]
                elif symmetric and j == i:
                    d[i, j] = 0.0
                else:
                    d[i, j] = emd_exact(a, b)
        return d

    d_gr = matrix(gen, ref)
    out = {"mmd_emd": float(d_gr.min(axis=0).mean()),
           "coverage_emd": float(len(np.unique(d_gr.argmin(axis=1)))
                                 / d_gr.shape[1]),
           "emd_cloud_points": int(points)}
    d_gg = matrix(gen, gen, symmetric=True)
    d_rr = matrix(ref, ref, symmetric=True)
    G, R = d_gr.shape
    d = np.block([[d_gg, d_gr], [d_gr.T, d_rr]])
    np.fill_diagonal(d, np.inf)
    labels = np.array([0] * G + [1] * R)
    out["one_nna_emd"] = float((labels[d.argmin(axis=1)] == labels).mean())
    return out
