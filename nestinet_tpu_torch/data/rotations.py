"""Rotation matrices for the trainer's augmentation.

The part of `nestinet_tpu/data/rotations.py` that training uses
(`euler2mat`, `random_rotation`), parity with the vendored
`utils/eulerangles.py`: intrinsic rotations applied z first, then y, then
x (`M = Mx @ My @ Mz` acting on column vectors).
"""

from __future__ import annotations

import math

import numpy as np


def euler2mat(z: float = 0.0, y: float = 0.0, x: float = 0.0) -> np.ndarray:
    """Rotation matrix for rotations around z, y, x axes (in that order)."""
    mats = []
    if z:
        c, s = math.cos(z), math.sin(z)
        mats.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))
    if y:
        c, s = math.cos(y), math.sin(y)
        mats.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    if x:
        c, s = math.cos(x), math.sin(x)
        mats.append(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
    if mats:
        # z is applied first => rightmost factor: M = Mx @ My @ Mz.
        m = mats[0]
        for nxt in mats[1:]:
            m = nxt @ m
        return m
    return np.eye(3)


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """The trainer's whole-batch rotation: R^T of euler2mat on three
    normal-distributed angles scaled by 2*pi
    (parity: `train_n_est_w_experts.py:269-270`)."""
    angles = 2.0 * np.pi * rng.randn(3)
    return euler2mat(z=angles[0], y=angles[1], x=angles[2]).T
