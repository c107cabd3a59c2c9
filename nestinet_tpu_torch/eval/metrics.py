"""Metric protocol: unoriented/oriented RMS angle error, PGP5, PGP10.

A copy of `nestinet_tpu/eval/metrics.py` (the helpers the scores use).

Exact parity with the reference's definitions (`utils/evaluate.py:134-158`):
    nn  = clip(<n_gt, n_pred>, -1, 1)           (after L2 normalization)
    ang = rad2deg(arccos(|nn|))                 (unoriented)
    RMS = sqrt(mean(ang^2)) per shape, averaged over shapes
    PGPk = fraction of eval points with ang < k degrees
    oriented RMS uses arccos(nn) without the absolute value
"""

from __future__ import annotations

import numpy as np


def _normalize_rows(v: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(v, axis=1, keepdims=True)
    norm = np.where(norm == 0, 1.0, norm)
    return v / norm


def angle_errors_deg(normals_gt: np.ndarray, normals_pred: np.ndarray):
    """(unoriented angle errors [deg], oriented angle errors [deg])."""
    gt = _normalize_rows(np.asarray(normals_gt, dtype=np.float64))
    pred = _normalize_rows(np.asarray(normals_pred, dtype=np.float64))
    nn = np.clip(np.sum(gt * pred, axis=1), -1.0, 1.0)
    ang = np.rad2deg(np.arccos(np.abs(nn)))
    ang_oriented = np.rad2deg(np.arccos(nn))
    return ang, ang_oriented


def rms_angle_deg(ang: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(ang))))


def pgp(ang: np.ndarray, threshold_deg: float) -> float:
    """Portion of good points: fraction with error under the threshold."""
    return float(np.mean(ang < threshold_deg))

