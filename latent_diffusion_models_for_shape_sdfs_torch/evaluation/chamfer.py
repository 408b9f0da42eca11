"""Chamfer-L2 metric (lineage evaluation contract, BASELINE.json:5).

The lineage evaluates reconstructions as the symmetric mean of squared
nearest-neighbour distances between 30k points sampled on the predicted
mesh and the ground-truth surface samples (KD-tree on host). We keep that
definition exactly: chamfer = mean_sq(pred->gt) + mean_sq(gt->pred).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def chamfer_l2(pred_pts: np.ndarray, gt_pts: np.ndarray) -> float:
    """Symmetric mean-of-squared-NN-distances. Lower is better."""
    pred = np.asarray(pred_pts, np.float64)
    gt = np.asarray(gt_pts, np.float64)
    d_pg, _ = cKDTree(gt).query(pred, k=1)
    d_gp, _ = cKDTree(pred).query(gt, k=1)
    return float(np.mean(d_pg ** 2) + np.mean(d_gp ** 2))


def chamfer_l2_directed(src_pts: np.ndarray, dst_pts: np.ndarray) -> float:
    """One direction only: mean squared NN distance src -> dst.

    src=pred attributes EXTRA predicted geometry (far from any GT point);
    src=gt attributes MISSING geometry (GT regions no predicted point
    covers): the diagnostic split of the symmetric metric above."""
    src = np.asarray(src_pts, np.float64)
    dst = np.asarray(dst_pts, np.float64)
    d, _ = cKDTree(dst).query(src, k=1)
    return float(np.mean(d ** 2))
