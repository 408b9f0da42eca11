"""F-score@tau and normal consistency (host NumPy / cKDTree).

The port's copy of the JAX package's `evaluation/fscore.py`. Chamfer-L2
is the lineage's contract metric (evaluation/chamfer.py); these two
complement it: F-score is bounded in [0,1] and splits extra geometry (low
precision) from missing geometry (low recall); normal consistency catches
surfaces at the right place with the wrong local orientation.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def fscore(pred_pts: np.ndarray, gt_pts: np.ndarray,
           tau: float = 0.01) -> dict:
    """F-score at distance threshold `tau` (absolute units). Returns
    {"fscore", "precision", "recall"}, all in [0,1]: precision = fraction
    of predicted points within tau of the GT points, recall = fraction of
    GT points within tau of the prediction, fscore = their harmonic mean
    (0 when both are 0)."""
    pred = np.asarray(pred_pts, np.float64)
    gt = np.asarray(gt_pts, np.float64)
    d_pg, _ = cKDTree(gt).query(pred, k=1)
    d_gp, _ = cKDTree(pred).query(gt, k=1)
    precision = float(np.mean(d_pg <= tau))
    recall = float(np.mean(d_gp <= tau))
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {"fscore": f, "precision": precision, "recall": recall}


def normal_consistency(pred_pts: np.ndarray, pred_normals: np.ndarray,
                       gt_pts: np.ndarray,
                       gt_normals: np.ndarray) -> float:
    """Symmetric mean |cos(angle)| between nearest-neighbour normals, in
    [0,1] (|cos|, so flipped orientation conventions do not count)."""
    pred = np.asarray(pred_pts, np.float64)
    gt = np.asarray(gt_pts, np.float64)

    def _unit(v):
        v = np.asarray(v, np.float64)
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.maximum(n, 1e-12)

    pn = _unit(pred_normals)
    gn = _unit(gt_normals)
    _, i_pg = cKDTree(gt).query(pred, k=1)
    _, i_gp = cKDTree(pred).query(gt, k=1)
    c_pg = np.abs(np.sum(pn * gn[i_pg], axis=-1)).mean()
    c_gp = np.abs(np.sum(gn * pn[i_gp], axis=-1)).mean()
    return float(0.5 * (c_pg + c_gp))


def sdf_normals(sdf_fn, pts: np.ndarray, h: float = 1e-4) -> np.ndarray:
    """Outward normals of an SDF's zero set at `pts` by central
    differences (the GT normals of analytic shapes, whose SDFs are
    exact). [n,3] f32."""
    pts = np.asarray(pts, np.float64)
    g = np.empty_like(pts)
    for ax in range(3):
        e = np.zeros(3)
        e[ax] = h
        g[:, ax] = (np.asarray(sdf_fn(pts + e), np.float64)
                    - np.asarray(sdf_fn(pts - e), np.float64)) / (2 * h)
    n = np.linalg.norm(g, axis=-1, keepdims=True)
    return (g / np.maximum(n, 1e-12)).astype(np.float32)
