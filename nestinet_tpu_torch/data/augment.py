"""Host-side batch augmentations.

A copy of `nestinet_tpu/data/augment.py`, on the port's own
`data/rotations.py` and (`starve_gaussians`) any GMM with `n_gaussians`
and `means`, such as `ops/gmm.py::GridGMM`; `occlude` takes scipy's
kd-tree, imported at call time.

Capability parity with the augmentation library in `utils/provider.py`
(rotate / translate / scale / jitter / outliers / occlusion / density
starvation, `provider.py:29-203`), vectorized over the batch where the
reference looped in Python, plus the trainers' whole-batch SO(3)
rotation (`train_n_est_w_experts.py:268-279`).
"""

from __future__ import annotations

import numpy as np

from .rotations import random_rotation


def rotate_patches_and_normals(points, normals, rng: np.random.RandomState):
    """One random SO(3) rotation applied to every patch in the batch and
    its ground-truth normal (the flagship trainer's augmentation)."""
    r = random_rotation(rng).astype(points.dtype)
    return points @ r, normals @ r


def rotate_y(batch, rng):
    """Per-cloud random rotation about the up (y) axis (`provider.py:29-47`)."""
    out = np.empty_like(batch)
    for k in range(batch.shape[0]):
        a = rng.uniform() * 2 * np.pi
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=batch.dtype)
        out[k] = batch[k] @ r
    return out


def rotate_y_by_angle(batch, angle):
    """Fixed-angle y rotation (`provider.py:67-84`)."""
    c, s = np.cos(angle), np.sin(angle)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=batch.dtype)
    return batch @ r


def rotate_x_by_angle(batch, angle):
    """Fixed-angle x rotation (`provider.py:86-103`)."""
    c, s = np.cos(angle), np.sin(angle)
    r = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=batch.dtype)
    return batch @ r


def translate(batch, rng, tval: float = 0.2):
    """Per-cloud uniform translation (`provider.py:49-64`)."""
    t = rng.uniform(-tval, tval, size=(batch.shape[0], 1, 3)).astype(batch.dtype)
    return batch + t


def anisotropic_scale(batch, rng, smin: float = 0.66, smax: float = 1.5):
    """Per-cloud random per-axis scaling (`provider.py:105-124`)."""
    s = rng.uniform(smin, smax, size=(batch.shape[0], 1, 3)).astype(batch.dtype)
    return batch * s


def jitter(batch, rng, sigma: float = 0.01, clip: float = 0.05):
    """Per-point Gaussian jitter, clipped (`provider.py:127-138`)."""
    assert clip > 0
    noise = np.clip(sigma * rng.randn(*batch.shape), -clip, clip).astype(batch.dtype)
    return batch + noise


def insert_outliers(batch, rng, outlier_ratio: float = 0.05):
    """Replace a fraction of points with unit-cube outliers
    (`provider.py:140-151`)."""
    b, n, c = batch.shape
    n_out = int(np.floor(outlier_ratio * n))
    outliers = rng.uniform(-1, 1, size=(b, n_out, c)).astype(batch.dtype)
    keep_idx = rng.choice(n, int(np.ceil(n * (1 - outlier_ratio))))
    return np.concatenate([batch[:, keep_idx, :], outliers], axis=1)


def occlude(batch, rng, occlusion_ratio: float):
    """Remove the k nearest neighbors of a random center per cloud
    (`provider.py:154-172`)."""
    from scipy import spatial

    b, n, _ = batch.shape
    k = int(round(n * occlusion_ratio))
    out = []
    for i in range(b):
        cloud = batch[i]
        tree = spatial.cKDTree(cloud)
        center = cloud[rng.randint(n)]
        _, idx = tree.query(center, k=k)
        out.append(np.delete(cloud, np.atleast_1d(idx), axis=0))
    return np.asarray(out)


def starve_gaussians(batch, gmm, rng, starv_coef: float = 0.6, n_points: int = 1024):
    """Density starvation around random GMM components
    (`provider.py:176-203`)."""
    b, n, _ = batch.shape
    k = gmm.n_gaussians
    d = np.sum(
        (batch[:, :, None, :] - gmm.means[None, None]) ** 2, axis=-1
    )  # [B,N,K]
    idx = np.argmin(d, axis=2)
    rx = rng.rand(b, n)
    sk = rng.choice([1.0, starv_coef], k)
    p = sk[idx] * rx
    out = []
    for i in range(b):
        top = np.argsort(p[i])[::-1][:n_points]
        out.append(batch[i, top])
    return np.asarray(out)
