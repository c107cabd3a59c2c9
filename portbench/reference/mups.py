"""The multi-scale point statistics (MuPS) of the reference, in PyTorch.

For each patch and radius: the modified 3-D Fisher vector of the patch's
points under a grid GMM of r^3 isotropic Gaussians on [-1, 1]^3 (centres
at linspace(-1 + 1/r, 1 - 1/r, r) per axis, last axis fastest, weights
1/K, variance v on every axis), with the reference's conventions: the
soft assignment q = w p / sum_k w p; rows 0..n_eff count as points (the
row at index n_eff, a zero pad, counts too); pad rows enter every max and
min as zeros; the d_pi (max, sum), d_mu and d_sigma (max, min, sum per
axis) statistics divided by max(n_eff, 1), signed square root, then L2
normalised over the Gaussians.  Sums over points and Gaussians in
float64.  The grid is [B, r, r, r, 20 S], channel s * 20 + c.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def grid_gmm(res: int, variance: float):
    """(w [K], mu [K, 3], sigma [K, 3]) as float64 NumPy arrays."""
    step = 1.0 / res
    axis = np.linspace(-1.0 + step, 1.0 - step, res)
    mesh = np.meshgrid(axis, axis, axis, indexing="ij")
    mu = np.stack([g.reshape(-1) for g in mesh], axis=-1)
    k = mu.shape[0]
    return np.full(k, 1.0 / k), mu, np.sqrt(np.full_like(mu, variance))


def _f64sum(x, dim, keepdim=False):
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=torch.float64).to(x.dtype)


def _finish(x, eff):
    x = x / eff
    x = torch.sign(x) * torch.sqrt(torch.abs(x))
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=1, keepdim=True), min=1e-12))


def fisher_rows(points: torch.Tensor, n_eff: torch.Tensor, w, mu, sigma) -> torch.Tensor:
    """[R, N, 3] float32 points (zero past n_eff), [R] n_eff -> [R, 20, K]."""
    R, N, _ = points.shape
    dev = points.device
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    z = (points[:, :, None, :] - mu) / sigma  # [R, N, K, 3]
    s0 = sigma[:, 0]
    coef = 1.0 / (math.pow(2.0 * math.pi, 1.5) * s0 * s0 * s0)
    wp = coef * torch.exp(-0.5 * torch.sum(z * z, dim=-1)) * w
    q = wp / _f64sum(wp, -1, keepdim=True)  # [R, N, K]
    real = (torch.arange(N, device=dev)[None] <= n_eff.to(torch.int64)[:, None])[..., None]
    q = torch.where(real, q, 0.0)
    dpi = torch.where(real, (q - w) / torch.sqrt(w), 0.0)
    eff = torch.clamp(n_eff, min=1).to(torch.float32)[:, None, None]
    d_pi = torch.stack([dpi.amax(1), _f64sum(dpi, 1)], dim=-1)
    qz = q[..., None] * z
    d_mu = torch.cat([qz.amax(1), qz.amin(1), _f64sum(qz, 1)], -1) / torch.sqrt(w)[:, None]
    qs = q[..., None] * (z * z - 1.0)
    d_sig = torch.cat([qs.amax(1), qs.amin(1), _f64sum(qs, 1)], -1) / torch.sqrt(2.0 * w)[:, None]
    fv = torch.cat([_finish(d_pi, eff), _finish(d_mu, eff), _finish(d_sig, eff)], dim=-1)
    return fv.transpose(1, 2)  # [R, 20, K]


def statistics_grid(points: torch.Tensor, n_eff: torch.Tensor, cfg: dict,
                    rows_per_call: int = 96) -> torch.Tensor:
    """[B, S, N, 3] patches and [B, S] n_eff -> the [B, r, r, r, 20 S]
    statistics grid, computed `rows_per_call` (patch, radius) rows at a
    time so that the [rows, N, K, 3] intermediates fit."""
    B, S, N, _ = points.shape
    res = cfg["num_gaussians"]
    w, mu, sigma = grid_gmm(res, cfg["gmm_variance"])
    flat, ne = points.reshape(B * S, N, 3), n_eff.reshape(B * S)
    rows = torch.cat([fisher_rows(flat[i:i + rows_per_call], ne[i:i + rows_per_call],
                                  w, mu, sigma)
                      for i in range(0, B * S, rows_per_call)])
    K = rows.shape[-1]
    return rows.reshape(B, S, 20, K).permute(0, 3, 1, 2).reshape(B, res, res, res, S * 20)
