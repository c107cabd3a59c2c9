"""Grid Gaussian mixture for the 3DmFV statistics.

A NumPy copy of `nestinet_tpu/ops/gmm.py` (`GridGMM`, `_grid_means`,
`get_3d_grid_gmm`, `get_2d_grid_gmm`, `get_gmm`): importing the original
pulls in JAX through `nestinet_tpu/ops/__init__.py`.  The data-learned
GMM (`get_gmm(type="learn")`, JAX's `get_learned_gmm`) fits with sklearn
and is not ported: it raises NotImplementedError (ROADMAP queue 1, item
6).  `GridGMM.load` reads a run dir's `gmm.json` unchanged, and the component order is the reference's C-order
with the last axis fastest, so Gaussian k sits at grid cell
(k // r², (k // r) % r, k % r).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridGMM:
    """An isotropic diagonal-covariance Gaussian mixture.

    Attributes:
        weights:     [K]    mixture weights (sum to 1).
        means:       [K, D] component means.
        covariances: [K, D] per-axis variances (sigma^2).
    """

    weights: np.ndarray
    means: np.ndarray
    covariances: np.ndarray

    @property
    def sigma(self) -> np.ndarray:
        """Per-axis standard deviations [K, D]."""
        return np.sqrt(self.covariances)

    @property
    def n_gaussians(self) -> int:
        return int(self.means.shape[0])

    @property
    def dim(self) -> int:
        return int(self.means.shape[1])

    @property
    def resolution(self) -> int:
        """Cube-root grid resolution (for D=3 grid GMMs)."""
        return int(round(self.n_gaussians ** (1.0 / self.dim)))

    def astuple(self):
        """(w [K], mu [K, D], sigma [K, D]) as float32."""
        return (
            self.weights.astype(np.float32),
            self.means.astype(np.float32),
            self.sigma.astype(np.float32),
        )

    def save(self, path: str) -> None:
        payload = {
            "weights": self.weights.tolist(),
            "means": self.means.tolist(),
            "covariances": self.covariances.tolist(),
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    @staticmethod
    def load(path: str) -> "GridGMM":
        with open(path) as f:
            payload = json.load(f)
        return GridGMM(
            weights=np.asarray(payload["weights"], dtype=np.float64),
            means=np.asarray(payload["means"], dtype=np.float64),
            covariances=np.asarray(payload["covariances"], dtype=np.float64),
        )


def _grid_means(subdivisions, lo=-1.0, hi=1.0) -> np.ndarray:
    """Centers `linspace(lo + step, hi - step, m)` per axis, step = 1/m,
    flattened in C-order with the last axis fastest."""
    axes = []
    for m in subdivisions:
        step = (hi - lo) / (2.0 * m)
        axes.append(np.linspace(lo + step, hi - step, m))
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in mesh], axis=-1)


def get_3d_grid_gmm(subdivisions=(5, 5, 5), variance=0.04) -> GridGMM:
    """K = m^3 isotropic Gaussians on a uniform grid over [-1, 1]^3 with
    uniform weights 1/K and `variance` on every axis."""
    subdivisions = list(subdivisions)
    if len(subdivisions) != 3:
        raise ValueError("get_3d_grid_gmm needs three subdivisions")
    means = _grid_means(subdivisions)
    k = means.shape[0]
    return GridGMM(
        weights=np.full((k,), 1.0 / k, dtype=np.float64),
        means=means.astype(np.float64),
        covariances=np.full_like(means, variance, dtype=np.float64),
    )


def get_2d_grid_gmm(subdivisions=(5, 5), variance=0.04) -> GridGMM:
    """The 2-D analog: m1 * m2 isotropic Gaussians on a uniform grid over
    [-1, 1]^2 (parity: `utils.py:98-122`)."""
    subdivisions = list(subdivisions)
    if len(subdivisions) != 2:
        raise ValueError("get_2d_grid_gmm needs two subdivisions")
    means = _grid_means(subdivisions)
    k = means.shape[0]
    return GridGMM(
        weights=np.full((k,), 1.0 / k, dtype=np.float64),
        means=means.astype(np.float64),
        covariances=np.full_like(means, variance, dtype=np.float64),
    )


def get_gmm(
    points: np.ndarray | None,
    n_gaussians,
    *,
    type: str = "grid",
    variance: float = 0.04,
    dim: int = 3,
    cache_dir: str | None = None,
) -> GridGMM:
    """The grid GMM of `n_gaussians` subdivisions per axis (an int or one
    per axis) in 2 or 3 dimensions (parity: `utils/utils.py:20-51`).
    `type="learn"` raises NotImplementedError: its sklearn fit is not
    ported."""
    if type == "grid":
        subdiv = (
            list(n_gaussians)
            if isinstance(n_gaussians, (list, tuple))
            else [int(n_gaussians)] * dim
        )
        if dim == 2:
            return get_2d_grid_gmm(subdiv[:2], variance=variance)
        if dim == 3:
            return get_3d_grid_gmm(subdiv[:3], variance=variance)
        raise ValueError("grid GMMs support dim 2 or 3")
    if type == "learn":
        raise NotImplementedError(
            "the learned GMM fits with sklearn, not ported yet: ROADMAP.md "
            "queue 1, item 6 (library leftovers)"
        )
    raise ValueError(f"unknown GMM type: {type!r} (grid|learn)")
