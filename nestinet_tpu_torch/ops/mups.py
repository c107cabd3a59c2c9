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

Training differentiates with respect to the parameters only: the points
are constants of the loss, as in JAX's `value_and_grad(loss_fn)(params)`,
so the backward never runs there.  `BACKWARD_CALLS["plain"]` counts the
calls of the backward, so that a run can show it.
"""

from __future__ import annotations

import math

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
