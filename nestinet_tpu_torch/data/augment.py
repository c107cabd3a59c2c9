"""Host-side batch augmentation.

The part of `nestinet_tpu/data/augment.py` that training uses: the
trainers' whole-batch SO(3) rotation (`train_n_est_w_experts.py:268-279`).
"""

from __future__ import annotations

import numpy as np

from .rotations import random_rotation


def rotate_patches_and_normals(points, normals, rng: np.random.RandomState):
    """One random SO(3) rotation applied to every patch in the batch and
    its ground-truth normal (the flagship trainer's augmentation)."""
    r = random_rotation(rng).astype(points.dtype)
    return points @ r, normals @ r
