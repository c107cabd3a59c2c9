"""Gaussian mixtures for the 3DmFV statistics: the grid and the learned.

A NumPy copy of `nestinet_tpu/ops/gmm.py` (`GridGMM`, `_grid_means`,
`get_3d_grid_gmm`, `get_2d_grid_gmm`, `get_gmm`, `get_learned_gmm`):
importing the original pulls in JAX through `nestinet_tpu/ops/__init__.py`.
`GridGMM.load` reads a run dir's `gmm.json` unchanged, and the component
order is the reference's C-order with the last axis fastest, so Gaussian k
sits at grid cell (k // r², (k // r) % r, k % r).

JAX fits the learned GMM with sklearn's `GaussianMixture(covariance_type=
"diag")` at its defaults (`:161-185`), which the card's machine does not
have.  `fit_diag_gmm` is that fit in NumPy: k-means initialisation
(greedy k-means++ seeding, then Lloyd's iterations), EM with REG_COVAR
1e-6 added to every variance, stopping when the per-sample log-likelihood
bound moves by less than TOL 1e-3, at most MAX_ITER 100 iterations, one
initialisation.  Its randomness comes from a `numpy.random.Generator`
seeded by `seed`; JAX's fit is unseeded.  The cache keeps JAX's file name
and JSON, so either package reads the other's cache.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

REG_COVAR = 1e-6  # sklearn GaussianMixture's defaults, which JAX's fit takes
TOL = 1e-3
MAX_ITER = 100
KMEANS_MAX_ITER = 300  # sklearn KMeans's defaults
KMEANS_TOL = 1e-4


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
    seed: int | np.random.Generator | None = None,
) -> GridGMM:
    """Dispatch between the grid-constructed and data-learned GMMs
    (parity: `utils/utils.py:20-51`): the grid GMM of `n_gaussians`
    subdivisions per axis (an int or one per axis) in 2 or 3 dimensions, or
    with `type="learn"` a diagonal GMM of `n_gaussians` components fitted
    to `points` [N, D] (`get_learned_gmm`, seeded by `seed`) and cached in
    `cache_dir` by data size."""
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
        if isinstance(n_gaussians, (list, tuple)):
            raise ValueError("learned GMM needs a scalar n_gaussians")
        if points is None:
            raise ValueError("learned GMM needs data points")
        return get_learned_gmm(points, int(n_gaussians), cache_dir=cache_dir, seed=seed)
    raise ValueError(f"unknown GMM type: {type!r} (grid|learn)")


def get_learned_gmm(points: np.ndarray, n_gaussians: int, cache_dir: str | None = None,
                    seed: int | np.random.Generator | None = None) -> GridGMM:
    """Fit a diagonal GMM to `points` [N, D] (`fit_diag_gmm`), once: with
    `cache_dir`, `gmm_g{n_gaussians}_N{N}.json` there is read when it
    exists and written after a fit (parity: `utils.py:34-47, 54-67`)."""
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"gmm_g{n_gaussians}_N{points.shape[0]}.json"
        )
        if os.path.isfile(cache):
            return GridGMM.load(cache)
    gmm = fit_diag_gmm(points, n_gaussians, np.random.default_rng(seed))
    if cache_dir is not None:
        gmm.save(cache)
    return gmm


def fit_diag_gmm(points: np.ndarray, n_components: int, rng: np.random.Generator) -> GridGMM:
    """sklearn's `GaussianMixture(n_components, covariance_type="diag")
    .fit(points)` in float64 NumPy: responsibilities one-hot on the k-means
    labels, then EM.  Each iteration takes the E step (the per-sample
    log-likelihood, whose mean is the bound) and the M step; it stops after
    the iteration whose bound moved by less than TOL (at most MAX_ITER),
    keeping that M step's parameters."""
    x = np.asarray(points, dtype=np.float64)
    n, dim = x.shape
    if n < n_components:
        raise ValueError(f"Expected n_samples >= n_components but got "
                         f"n_components = {n_components}, n_samples = {n}")
    resp = np.zeros((n, n_components))
    resp[np.arange(n), kmeans_labels(x, n_components, rng)] = 1.0
    nk, means, covariances = _gaussian_parameters(x, resp)
    weights = nk / n
    bound = -np.inf
    for _ in range(MAX_ITER):
        prev = bound
        log_prob = _log_gaussian_prob(x, means, covariances) + np.log(weights)
        norm = _logsumexp(log_prob)
        nk, means, covariances = _gaussian_parameters(x, np.exp(log_prob - norm[:, None]))
        weights = nk / nk.sum()
        bound = norm.mean()
        if abs(bound - prev) < TOL:
            break
    return GridGMM(weights=weights, means=means, covariances=covariances)


def _gaussian_parameters(x, resp):
    """(nk, means, variances) of responsibilities `resp` [N, K], as
    sklearn's `_estimate_gaussian_parameters` for diagonal covariances."""
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, None]
    covariances = (resp.T @ (x * x)) / nk[:, None] - means ** 2 + REG_COVAR
    if np.any(covariances <= 0.0):
        raise ValueError("Fitting the mixture model failed because some components have "
                         "ill-defined empirical covariance (for instance caused by singleton "
                         "or collapsed samples). Try to decrease the number of components, "
                         "or increase reg_covar.")
    return nk, means, covariances


def _log_gaussian_prob(x, means, covariances):
    """[N, K] log N(x | mean_k, diag(var_k)), in sklearn's precision form."""
    prec_chol = 1.0 / np.sqrt(covariances)
    precisions = prec_chol ** 2
    log_prob = (np.sum(means ** 2 * precisions, axis=1)
                - 2.0 * (x @ (means * precisions).T)
                + (x ** 2) @ precisions.T)
    return -0.5 * (x.shape[1] * math.log(2 * math.pi) + log_prob) + np.sum(np.log(prec_chol),
                                                                          axis=1)


def _logsumexp(a):
    top = a.max(axis=1)
    return top + np.log(np.exp(a - top[:, None]).sum(axis=1))


def _squared_distances(x, centers, xx):
    """[N, C] squared distances |x|^2 - 2 x.c + |c|^2 (`xx` the rows'
    |x|^2), clipped at 0, in one [N, C] array."""
    d = x @ centers.T
    d *= -2.0
    d += xx[:, None]
    d += (centers * centers).sum(axis=1)
    return np.maximum(d, 0.0, out=d)


def _lloyd_step(x, xx, centers):
    """One Lloyd iteration: ([N] labels, [C, D] centers moved to their
    points' means).  Each empty cluster takes one of the points farthest
    from their centers; a cluster left with no point sits at the largest
    cluster's center (sklearn's `_average_centers`)."""
    n, dim, k = x.shape[0], x.shape[1], centers.shape[0]
    # the nearest center minimizes |c|^2 - 2 x.c: |x|^2 is the row's own
    scores = x @ (-2.0 * centers.T)
    scores += (centers * centers).sum(axis=1)
    labels = np.argmin(scores, axis=1)
    counts = np.bincount(labels, minlength=k)
    empty = np.flatnonzero(counts == 0)
    if len(empty):
        far = np.argsort(-(scores[np.arange(n), labels] + xx))[:len(empty)]
        np.subtract.at(counts, labels[far], 1)
        labels[far], counts[empty] = empty, 1
    moved = np.stack([np.bincount(labels, weights=x[:, d], minlength=k)
                      for d in range(dim)], axis=1) / np.maximum(counts, 1)[:, None]
    moved[counts == 0] = moved[np.argmax(counts)]
    return labels, moved


def kmeans_labels(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """[N] cluster labels of one k-means run, as sklearn's `KMeans(k,
    n_init=1)`: greedy k-means++ seeding (2 + ln k candidates a center,
    each the one that lowers the potential most), then Lloyd's iterations
    (`_lloyd_step`, at most KMEANS_MAX_ITER) until the labels stop changing
    or the centers move by at most KMEANS_TOL times the data's mean
    variance (summed squared shifts)."""
    n, dim = x.shape
    xx = (x * x).sum(axis=1)
    centers = np.empty((k, dim))
    centers[0] = x[rng.integers(n)]
    closest = ((x - centers[0]) ** 2).sum(axis=1)
    trials = 2 + int(np.log(k))
    for c in range(1, k):
        ids = np.searchsorted(np.cumsum(closest), rng.random(trials) * closest.sum())
        ids = np.minimum(ids, n - 1)
        cand = np.minimum(closest[None, :], _squared_distances(x, x[ids], xx).T)
        best = int(np.argmin(cand.sum(axis=1)))
        closest, centers[c] = cand[best], x[ids[best]]
    tol = KMEANS_TOL * float(np.mean(np.var(x, axis=0)))
    labels = None
    for _ in range(KMEANS_MAX_ITER):
        new, moved = _lloyd_step(x, xx, centers)
        shift = float(((moved - centers) ** 2).sum())
        centers = moved
        if labels is not None and np.array_equal(new, labels):
            break
        labels = new
        if shift <= tol:
            break
    return np.argmin(_squared_distances(x, centers, xx), axis=1)
