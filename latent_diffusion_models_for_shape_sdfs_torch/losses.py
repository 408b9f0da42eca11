"""Loss functions with pinned semantics (SEMANTICS.md sections 1-2).

Counterpart of the JAX package's `losses.py`: clamp each operand, then
subtract, sum-reduce, divide by the batch's total sample count (the
lineage's `L1Loss(reduction="sum") / num_sdf_samples`). Everything is
computed in float32, the epoch ramp too.
"""

from __future__ import annotations

import numpy as np
import torch


def clamped_l1(pred_sdf: torch.Tensor, gt_sdf: torch.Tensor,
               clamp_dist: float = 0.1,
               num_sdf_samples: int | None = None) -> torch.Tensor:
    """Sum_i |clamp(pred_i, +-d) - clamp(gt_i, +-d)| / num_sdf_samples.

    `num_sdf_samples` defaults to the element count of `pred_sdf`."""
    pred = torch.clamp(pred_sdf.float(), -clamp_dist, clamp_dist)
    gt = torch.clamp(gt_sdf.float(), -clamp_dist, clamp_dist)
    n = pred.numel() if num_sdf_samples is None else num_sdf_samples
    return torch.sum(torch.abs(pred - gt)) / n


def code_reg(batch_codes: torch.Tensor, epoch, code_reg_lambda: float = 1e-4,
             warmup_epochs: int = 100, num_sdf_samples: int = 1,
             squared: bool = False) -> torch.Tensor:
    """lambda * min(1, epoch/warmup) * sum_i ||z_i|| / num_sdf_samples.

    `batch_codes` holds the gathered codes of this step (rows, latent);
    `squared=True` sums squared norms (the paper form) instead. The
    epoch ramp is computed on the host in float32, so a step on the card
    copies nothing to it."""
    z = batch_codes.float()
    sq = torch.sum(z * z, dim=-1)
    size_loss = torch.sum(sq) if squared else torch.sum(torch.sqrt(sq))
    scale = float(np.float32(code_reg_lambda) * np.minimum(
        np.float32(epoch) / np.float32(warmup_epochs), np.float32(1.0)))
    return scale * size_loss / num_sdf_samples


def eps_mse(eps: torch.Tensor, eps_hat: torch.Tensor) -> torch.Tensor:
    """Diffusion training loss: mean over batch and dims (SEMANTICS.md s6)."""
    d = eps_hat.float() - eps.float()
    return torch.mean(d * d)
