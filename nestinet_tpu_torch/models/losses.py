"""Angular loss functions for unoriented normal estimation.

Counterpart of `nestinet_tpu/models/losses.py` (`:26-86`), parity with the
reference loss family (`models/ss_norm_est.py:115-142`,
`models/experts_n_est.py:111-152`):
  * 'cos':       1 - |cos| with a quadratic bowl below 0.01 (huber-like);
  * 'euclidean': min(||gt - pred||^2, ||gt + pred||^2) (sign-flip invariant);
  * 'sin':       2 * ||pred x gt|| (the flagship's default).
Mixture-of-experts aggregation (`experts_n_est.py:141-150`):
  * 'simple':   sum_i prob_i * diff_i, averaged over the batch;
  * 'gaussian': -log sum_i prob_i * N(diff_i), averaged over the batch.

Every norm is eps-guarded, sqrt(sum + 1e-12), as in JAX: a zero prediction
keeps a finite gradient.  `switching_loss` comes with the ablation models.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def safe_normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + _EPS)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0, which is 1 (torch.abs has 0 there):
    a zero prediction's cos is exactly 0, and its 'cos' loss gradient
    follows JAX's."""
    return torch.where(x >= 0, x, -x)


def angular_diff(n_pred: torch.Tensor, n_gt: torch.Tensor, loss_type: str):
    """Per-sample angular difference on the trailing xyz axis.

    Returns (diff, cos_ang); leading axes are kept ([B, 3] and [E, B, 3]
    expert stacks alike)."""
    n_pred = safe_normalize(n_pred)
    n_gt = safe_normalize(n_gt)
    cos_ang = torch.sum(n_pred * n_gt, dim=-1)
    if loss_type == "cos":
        one_minus_cos = 1.0 - _abs(cos_ang)
        diff = torch.where(one_minus_cos > 0.01, one_minus_cos, 100.0 * one_minus_cos ** 2)
    elif loss_type == "euclidean":
        diff = torch.minimum(
            torch.sum((n_gt - n_pred) ** 2, dim=-1),
            torch.sum((n_gt + n_pred) ** 2, dim=-1),
        )
    elif loss_type == "sin":
        n_gt = n_gt.expand_as(n_pred)
        cross = torch.linalg.cross(n_pred, n_gt, dim=-1)
        diff = 2.0 * torch.sqrt(torch.sum(cross * cross, dim=-1) + _EPS)
    else:
        raise ValueError(f"unknown loss type: {loss_type}")
    return diff, cos_ang


def normal_loss(n_pred: torch.Tensor, n_gt: torch.Tensor, loss_type: str = "cos"):
    """Single-prediction loss (ss / ms / switching models)."""
    diff, cos_ang = angular_diff(n_pred, n_gt, loss_type)
    return torch.mean(diff), cos_ang


def moe_loss(n_pred: torch.Tensor, n_gt: torch.Tensor, experts_prob: torch.Tensor,
             loss_type: str = "sin", expert_type: str = "simple"):
    """Mixture-of-experts loss.

    Args:
        n_pred: [E, B, 3] per-expert predictions.
        n_gt: [B, 3] ground truth.
        experts_prob: [E, B] manager probabilities.
    Returns:
        (scalar loss, cos_ang [E, B]).
    """
    diff, cos_ang = angular_diff(n_pred, n_gt[None], loss_type)  # [E, B]
    if expert_type == "simple":
        loss = torch.mean(torch.sum(experts_prob * diff, dim=0))
    elif expert_type == "gaussian":
        lik = (1.0 / (2.0 * math.pi)) * torch.exp(-0.5 * (diff * diff))
        loss = torch.mean(-torch.log(torch.sum(experts_prob * lik, dim=0) + _EPS))
    else:
        raise ValueError(f"unknown expert loss type: {expert_type}")
    return loss, cos_ang
