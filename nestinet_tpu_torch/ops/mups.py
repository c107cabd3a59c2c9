"""3D modified Fisher Vector (3DmFV) statistics and the multi-scale stack
(MuPS), in PyTorch.

Counterpart of `nestinet_tpu/ops/mups.py` (`tdmfv_n_est:60-155`,
`mups:158-211`).  `tdmfv_n_est_reference` is the plain broadcast-and-reduce
version; `tdmfv_n_est` runs the CUDA kernel (`csrc/mups_kernel.cu`) on a
CUDA tensor and the plain version on a CPU tensor, and differentiates
through the plain version, as the JAX kernel's custom VJP does
(`ops/pallas/mups_kernel.py:180-191`).  That device check is the only
place that chooses between the two.

Every quirk of the reference is kept: the strict mask `row <= n_eff` (the
row at index n_eff counts as real); masked rows enter every max/min as
zeros; `n_eff == 0` divides by 1; the pdf coefficient is isotropic
(sigma[:, 0]^3); the order is /eff, then signed sqrt, then L2 over K.
The sums over points and Gaussians accumulate in float64 (see `_sum`).

The 3DmFV variants that no model of the package calls
(`tdmfv_classification`, `tdmfv_sym`, `fv`, `tdmfv_seg`,
`nestinet_tpu/ops/mups.py:214-381`) and the NumPy Fisher-vector helpers
(`:389-478`) follow at the end: plain tensor functions that autograd
differentiates (no TPU kernel stands behind them), their sums over
points and Gaussians taken in float64 as in `tdmfv_n_est_reference`.

Training differentiates with respect to the parameters only: the points
are constants of the loss, as in JAX's `value_and_grad(loss_fn)(params)`,
so the backward never runs there.  `BACKWARD_CALLS["plain"]` counts the
calls of the backward, so that a run can show it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .kernels import mups_cuda

N_CHANNELS = 20

BACKWARD_CALLS = {"plain": 0}


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """tf.nn.l2_normalize: x * rsqrt(max(sum(x^2), eps))."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def _signed_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def _sum(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """A sum accumulated in float64, rounded back to x's dtype.

    The signed square root magnifies a sum's rounding wherever the sum
    cancels to near zero (the d_pi sum does for some Gaussians), so two
    float32 sums taken in different orders can differ there by more than
    1e-5.  Summing exactly makes this version and the CUDA kernel, which
    accumulates in double too, agree whatever their order.
    """
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=torch.float64).to(x.dtype)


def tdmfv_n_est_reference(
    points: torch.Tensor,
    w: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    n_eff: torch.Tensor,
) -> torch.Tensor:
    """Plain 3DmFV statistics with zero-padding compensation.

    Args:
        points: [R, N, 3] patch points (zero-padded to N).
        w:      [K] Gaussian weights.
        mu:     [K, 3] Gaussian means.
        sigma:  [K, 3] Gaussian standard deviations.
        n_eff:  [R] effective point count per patch.

    Returns:
        [R, 20, K]: the 20 channel rows per Gaussian, power- and
        L2-normalized.
    """
    R, N, D = points.shape
    dtype = points.dtype
    w = w.to(dtype)
    mu = mu.to(dtype)
    sigma = sigma.to(dtype)

    scaled = (points[:, :, None, :] - mu[None, None]) / sigma[None, None]  # [R,N,K,D]
    dist2 = torch.sum(scaled * scaled, dim=-1)  # [R,N,K]
    s0 = sigma[:, 0]
    coef = 1.0 / (math.pow(2.0 * math.pi, D / 2.0) * (s0 * s0 * s0))  # [K]
    p = coef[None, None] * torch.exp(-0.5 * dist2)
    wp = p * w[None, None]
    q = wp / _sum(wp, dim=-1, keepdim=True)  # [R,N,K]

    row = torch.arange(N, device=points.device)[None, :]
    real = (row <= n_eff.to(torch.int64)[:, None])[:, :, None]  # [R,N,1]
    zero = torch.zeros((), dtype=dtype, device=points.device)
    q = torch.where(real, q, zero)
    rsqrt_w = torch.rsqrt(w)
    d_pi_all = torch.where(real, (q - w[None, None]) * rsqrt_w[None, None], zero)
    eff = torch.clamp(n_eff, min=1).to(dtype)[:, None, None]  # [R,1,1]

    d_pi = torch.stack(
        [torch.amax(d_pi_all, dim=1), _sum(d_pi_all, dim=1)], dim=-1
    )  # [R,K,2]
    q4 = q[..., None]
    d_mu_all = q4 * scaled
    d_mu = torch.cat(
        [
            torch.amax(d_mu_all, dim=1),
            torch.amin(d_mu_all, dim=1),
            _sum(d_mu_all, dim=1),
        ],
        dim=-1,
    ) * rsqrt_w[None, :, None]  # [R,K,9]
    d_sig_all = q4 * (scaled * scaled - 1.0)
    d_sigma = torch.cat(
        [
            torch.amax(d_sig_all, dim=1),
            torch.amin(d_sig_all, dim=1),
            _sum(d_sig_all, dim=1),
        ],
        dim=-1,
    ) * torch.rsqrt(2.0 * w)[None, :, None]  # [R,K,9]

    d_pi = _l2_normalize(_signed_sqrt(d_pi / eff), dim=1)
    d_mu = _l2_normalize(_signed_sqrt(d_mu / eff), dim=1)
    d_sigma = _l2_normalize(_signed_sqrt(d_sigma / eff), dim=1)

    fv = torch.cat([d_pi, d_mu, d_sigma], dim=-1)  # [R,K,20]
    return fv.transpose(1, 2).contiguous()  # [R,20,K]


class _TdmfvNEst(torch.autograd.Function):
    """Kernel forward (plain forward on the CPU); backward by autograd
    through the plain version."""

    @staticmethod
    def forward(ctx, points, w, mu, sigma, n_eff):
        ctx.save_for_backward(points, w, mu, sigma, n_eff)
        if points.device.type == "cpu":
            return tdmfv_n_est_reference(points, w, mu, sigma, n_eff)
        return mups_cuda.tdmfv_n_est_cuda(points, w, mu, sigma, n_eff)

    @staticmethod
    def backward(ctx, grad):
        BACKWARD_CALLS["plain"] += 1
        points, w, mu, sigma, n_eff = ctx.saved_tensors
        with torch.enable_grad():
            p = points.detach().requires_grad_(True)
            out = tdmfv_n_est_reference(p, w, mu, sigma, n_eff)
            (d_points,) = torch.autograd.grad(out, p, grad)
        return d_points, None, None, None, None


def tdmfv_n_est(points, w, mu, sigma, n_eff) -> torch.Tensor:
    """[R, N, 3] points, [R] int32 n_eff -> [R, 20, K] statistics;
    differentiable with respect to `points`."""
    return _TdmfvNEst.apply(points, w, mu, sigma, n_eff)


def stats_to_grid(stats: torch.Tensor, batch: int, n_scales: int, resolution: int):
    """[B*S, 20, K] row statistics -> [B, r, r, r, 20*S] grid; channel c of
    scale s lands at s*20 + c."""
    K = stats.shape[-1]
    fv = stats.reshape(batch, n_scales, N_CHANNELS, K).permute(0, 3, 1, 2)
    return fv.reshape(
        batch, resolution, resolution, resolution, n_scales * N_CHANNELS
    )


def mups(
    points: torch.Tensor,
    n_eff: torch.Tensor,
    w: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    *,
    n_scales: int,
    resolution: int,
) -> torch.Tensor:
    """Multi-scale point statistics grid.

    Args:
        points: [B, n_scales * N, 3] concatenated per-scale patches.
        n_eff:  [B, n_scales] effective point counts.
    Returns:
        [B, res, res, res, 20 * n_scales] (channels last, as the JAX
        reference lays it out).
    """
    B, total, D = points.shape
    N = total // n_scales
    rows = tdmfv_n_est(
        points.reshape(B * n_scales, N, D).contiguous(),
        w, mu, sigma,
        n_eff.reshape(B * n_scales).to(torch.int32).contiguous(),
    )
    return stats_to_grid(rows, B, n_scales, resolution)


# ---------------------------------------------------------------------------
# 3DmFV variants (library functions carried over from 3DmFV-Net; no model
# calls them).  Points [B, N, D]; w [K]; mu, sigma [K, D].
# ---------------------------------------------------------------------------


def _finalize(d_pi, d_mu, d_sigma, *, flatten: bool, normalize: bool = True):
    """Shared tail: signed sqrt, per-channel L2 over Gaussians, layout
    [B, C, K] (flattened to [B, C*K])."""
    if normalize:
        d_pi = _l2_normalize(_signed_sqrt(d_pi), dim=1)
        d_mu = _l2_normalize(_signed_sqrt(d_mu), dim=1)
        d_sigma = _l2_normalize(_signed_sqrt(d_sigma), dim=1)
    fv = torch.cat([d_pi, d_mu, d_sigma], dim=-1).transpose(1, 2)
    if flatten:
        return fv.reshape(fv.shape[0], -1)
    return fv


def _soft_assign(points, w, mu, sigma):
    """(w in the points' dtype, scaled offsets [B,N,K,D], soft assignment
    Q [B,N,K]) under the diagonal GMM's true pdf (per-axis sigmas)."""
    w, mu, sigma = (a.to(points.dtype) for a in (w, mu, sigma))
    scaled = (points[:, :, None, :] - mu[None, None]) / sigma[None, None]
    dist2 = torch.sum(scaled * scaled, dim=-1)
    coef = 1.0 / (math.pow(2.0 * math.pi, mu.shape[1] / 2.0) * torch.prod(sigma, dim=-1))
    p = coef[None, None] * torch.exp(-0.5 * dist2)
    wp = p * w[None, None]
    q = wp / _sum(wp, dim=-1, keepdim=True)
    return w, scaled, q


def _max_min_sum(x):
    """[B, N, K, D] -> [B, K, 3D]: max, min and sum over the points."""
    return torch.cat([torch.amax(x, dim=1), torch.amin(x, dim=1), _sum(x, dim=1)], dim=-1)


def tdmfv_classification(points, w, mu, sigma, *, flatten: bool = True):
    """Classification-flavored 3DmFV (parity: `tf_util.py:578-652`): no
    padding compensation; the static point count is folded into the
    derivatives before the max/min/sum reductions.  [B, 20*K] (or
    [B, 20, K] unflattened)."""
    B, N, D = points.shape
    w, scaled, q = _soft_assign(points, w, mu, sigma)
    sqrt_w = torch.sqrt(w)

    d_pi_all = (q - w[None, None]) / (sqrt_w[None, None] * N)
    d_pi = torch.stack([torch.amax(d_pi_all, dim=1), _sum(d_pi_all, dim=1)], dim=-1)
    q4 = q[..., None]
    d_mu = _max_min_sum(q4 * scaled) / (N * sqrt_w[None, :, None])
    d_sigma = _max_min_sum(q4 * (scaled * scaled - 1.0)) / (
        N * torch.sqrt(2.0 * w)[None, :, None])
    return _finalize(d_pi, d_mu, d_sigma, flatten=flatten)


def tdmfv_sym(points, w, mu, sigma, *, sym_type: str = "max", flatten: bool = True):
    """3DmFV with a single symmetric aggregation ('max' | 'min' | 'ss', the
    sum of squares): 7 channels per Gaussian (parity: `tf_util.py:756-836`)."""
    B, N, D = points.shape
    w, scaled, q = _soft_assign(points, w, mu, sigma)
    q4 = q[..., None]

    d_pi_all = ((q - w[None, None]) / (torch.sqrt(w)[None, None] * N))[..., None]
    d_mu_all = q4 * scaled
    d_sig_all = q4 * (scaled * scaled - 1.0)

    mu_scale = 1.0 / (N * torch.sqrt(w))[None, :, None]
    sig_scale = 1.0 / (N * torch.sqrt(2.0 * w))[None, :, None]
    if sym_type == "max":
        agg = lambda x: torch.amax(x, dim=1)  # noqa: E731
    elif sym_type == "min":
        agg = lambda x: torch.amin(x, dim=1)  # noqa: E731
    elif sym_type == "ss":
        agg = lambda x: _sum(x * x, dim=1)  # noqa: E731
    else:
        raise ValueError(f"unknown sym_type: {sym_type}")
    return _finalize(agg(d_pi_all), mu_scale * agg(d_mu_all), sig_scale * agg(d_sig_all),
                     flatten=flatten)


def fv(points, w, mu, sigma, *, flatten: bool = True, normalize: bool = True):
    """Plain (sum-aggregated) Fisher vector: 7 channels per Gaussian
    (parity: `tf_util.py:839-993`)."""
    B, N, D = points.shape
    w, scaled, q = _soft_assign(points, w, mu, sigma)
    q4 = q[..., None]
    sqrt_w = torch.sqrt(w)

    d_pi = _sum((q - w[None, None]) / sqrt_w[None, None], dim=1)[..., None]
    d_mu = _sum(q4 * scaled, dim=1) / sqrt_w[None, :, None]
    d_sigma = _sum(q4 * (scaled * scaled - 1.0), dim=1) / torch.sqrt(2.0 * w)[None, :, None]
    return _finalize(d_pi / N, d_mu / N, d_sigma / N, flatten=flatten, normalize=normalize)


def tdmfv_seg(points, w, mu, sigma, *, flatten: bool = True):
    """Segmentation-flavored 3DmFV (parity: `tf_util.py:996-1080`): the
    20-channel global statistics and the unaggregated per-point 7-channel
    features.  Returns (fv [B, 20*K], fv_per_point [B, N, 7*K])."""
    B, N, D = points.shape
    w, scaled, q = _soft_assign(points, w, mu, sigma)
    q4 = q[..., None]
    inv_n = 1.0 / N

    d_pi_all = (inv_n * (q - w[None, None]) / torch.sqrt(w)[None, None])[..., None]
    d_mu_all = q4 * scaled
    d_sig_all = q4 * (scaled * scaled - 1.0)

    d_pi = torch.cat([torch.amax(d_pi_all, dim=1), _sum(d_pi_all, dim=1)], dim=-1)
    d_mu = inv_n / torch.sqrt(w)[None, :, None] * _max_min_sum(d_mu_all)
    d_sigma = inv_n / torch.sqrt(2.0 * w)[None, :, None] * _max_min_sum(d_sig_all)
    out = _finalize(d_pi, d_mu, d_sigma, flatten=flatten)
    per_point = torch.cat([d_pi_all, d_mu_all, d_sig_all], dim=3).reshape(B, N, -1)
    return out, per_point


# ---------------------------------------------------------------------------
# NumPy reference implementations (host-side; parity with the reference's
# oracles `utils/utils.py:147-330`).  `gmm` has weights [K], means [K, D]
# and covariances [K, D] (`ops/gmm.py::GridGMM`).
# ---------------------------------------------------------------------------


def soft_assignment_np(points: np.ndarray, gmm) -> np.ndarray:
    """Posterior responsibilities q[n, k] of each point under a diagonal
    GMM."""
    points = np.atleast_2d(points)
    weights, means, covariances = gmm.weights, gmm.means, gmm.covariances
    diff = points[:, None, :] - means[None]  # [N,K,D]
    log_p = -0.5 * np.sum(diff ** 2 / covariances[None], axis=-1)
    log_p += -0.5 * np.sum(np.log(2.0 * np.pi * covariances), axis=-1)[None]
    log_wp = log_p + np.log(weights)[None]
    log_wp -= log_wp.max(axis=1, keepdims=True)
    q = np.exp(log_wp)
    q /= q.sum(axis=1, keepdims=True)
    return q


def fisher_vector_np(xx: np.ndarray, gmm, normalization: bool = True) -> np.ndarray:
    """Classic (sum-aggregated) Fisher vector of a point set (parity:
    `utils/utils.py:147-211`, the Sanchez et al. formulation with
    signed-sqrt power normalization and per-column L2 normalization)."""
    xx = np.atleast_2d(xx)
    n_points = xx.shape[0]
    weights, means, covariances = gmm.weights, gmm.means, gmm.covariances
    D = means.shape[1]

    q = soft_assignment_np(xx, gmm)  # [N,K]
    s0 = q.sum(0)[:, None] / n_points
    s1 = q.T @ xx / n_points
    s2 = q.T @ (xx ** 2) / n_points

    tiled_w = np.tile(weights[:, None], [1, D])
    d_pi = (s0.squeeze() - n_points * weights) / np.sqrt(weights)
    d_mu = (s1 - means * s0) / np.sqrt(tiled_w * covariances)
    d_sigma = (s2 - 2 * s1 * means + s0 * means ** 2 - s0 * covariances) / (
        np.sqrt(2 * tiled_w) * covariances
    )

    alpha = 0.5
    d_pi = np.sign(d_pi) * np.abs(d_pi) ** alpha
    d_mu = np.sign(d_mu) * np.abs(d_mu) ** alpha
    d_sigma = np.sign(d_sigma) * np.abs(d_sigma) ** alpha

    if normalization:
        def _norm_cols(a):
            n = np.linalg.norm(a, axis=0, keepdims=True)
            return a / np.where(n == 0, 1.0, n)

        d_pi = _norm_cols(d_pi[:, None]).ravel()
        d_mu = _norm_cols(d_mu)
        d_sigma = _norm_cols(d_sigma)

    return np.hstack((d_pi, d_mu.flatten(), d_sigma.flatten()))


def fisher_vector_per_point_np(xx: np.ndarray, gmm):
    """Per-point (unaggregated) Fisher-vector derivatives (parity:
    `utils/utils.py:214-245`): (d_pi [N, K], d_mu [N, K, D],
    d_sigma [N, K, D])."""
    xx = np.atleast_2d(xx)
    weights, means, covariances = gmm.weights, gmm.means, gmm.covariances

    q = soft_assignment_np(xx, gmm)  # [N, K]
    d_pi = (q - weights[None]) / np.sqrt(weights)[None]
    x_mu = xx[:, None, :] - means[None]  # [N, K, D]
    sqrt_w = np.sqrt(weights)[None, :, None]
    d_mu = q[..., None] * x_mu / (np.sqrt(covariances)[None] * sqrt_w)
    d_sigma = (
        q[..., None]
        * (np.square(x_mu) / covariances[None] - 1.0)
        / (np.sqrt(2.0) * sqrt_w)
    )
    return d_pi, d_mu, d_sigma
