"""Fisher-vector / GMM visualization: statistics heatmaps, grid-GMM
ellipsoids, a patch beside its statistics, per-point derivative
magnitudes and responsibilities.

The counterpart of `nestinet_tpu/viz/fv.py`, drawn on the port's NumPy
canvas (`viz/canvas.py`) instead of matplotlib: the same functions,
parameters and defaults, the same limits, marker colors and positions.
`visualize_fv`'s rows are laid out on a fixed grid in place of
matplotlib's constrained-layout solver.  Figures are written as PNG only
(`fmt` other than "png" raises ValueError: the canvas has no vector
backend).
"""

from __future__ import annotations

import numpy as np

from .canvas import check_fmt, figure

# Channel row labels in the framework's [20, K] statistics layout
# (ops/mups.py: d_pi max/sum, d_mu max/min/sum xyz, d_sigma max/min/sum xyz).
CHANNEL_NAMES = (
    ["pi_max", "pi_sum"]
    + [f"mu_{s}_{d}" for s in ("max", "min", "sum") for d in "xyz"]
    + [f"sig_{s}_{d}" for s in ("max", "min", "sum") for d in "xyz"]
)


def visualize_fv(
    fv: np.ndarray,
    *,
    resolution: int | None = None,
    n_scales: int = 1,
    max_n_samples: int = 5,
    normalize: bool = True,
    filename: str | None = None,
    fmt: str = "png",
    fig_title: str = "3DmFV statistics",
):
    """Heatmap grid of 3DmFV statistics (parity: `visualization.py:150-225`).

    Args:
        fv: [B, 20 * n_scales, K] or [B, 20 * n_scales * K] statistics
            (channel-major, as produced by `ops.mups.tdmfv_n_est`).
        resolution: grid resolution m (K = m^3); inferred when None.
        n_scales: number of concatenated scales.
        max_n_samples: plot at most this many batch rows.
        normalize: rescale each channel row to [-1, 1] for display.
    Returns the figure.
    """
    check_fmt(fmt)
    fv = np.asarray(fv)
    if fv.ndim == 1:
        fv = fv[None]
    n_channels = 20 * n_scales
    if fv.ndim == 2:  # [B, 20*S*K] flattened
        fv = fv.reshape(fv.shape[0], n_channels, -1)
    B, C, K = fv.shape
    if resolution is None:
        resolution = int(round(K ** (1.0 / 3.0)))
    n = min(B, max_n_samples)

    fig = figure(figsize=(10, 2.2 * n), layout="constrained")
    axes = fig.subplots(n, 1, squeeze=False)
    fig.suptitle(fig_title)
    for i in range(n):
        img = fv[i].astype(np.float64)
        if normalize:
            peak = np.max(np.abs(img), axis=1, keepdims=True)
            img = img / np.where(peak == 0, 1.0, peak)
        ax = axes[i][0]
        im = ax.imshow(img, aspect="auto", cmap="seismic", vmin=-1, vmax=1)
        ax.set_ylabel("channel")
        ax.set_xlabel(f"Gaussian (K = {resolution}^3 x {n_scales} scales)")
        fig.colorbar(im, ax=ax, fraction=0.025)
    if filename:
        fig.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return fig


def unit_sphere(subdiv: int = 12):
    """Lat/long unit-sphere mesh: (x, y, z), each [subdiv, subdiv]
    (parity: `visualization.py:538-551`)."""
    u = np.linspace(0, 2 * np.pi, subdiv)
    v = np.linspace(0, np.pi, subdiv)
    x = np.outer(np.cos(u), np.sin(v))
    y = np.outer(np.sin(u), np.sin(v))
    z = np.outer(np.ones_like(u), np.cos(v))
    return x, y, z


def draw_gaussians(
    gmm,
    *,
    ax=None,
    n_std: float = 1.0,
    weight_threshold: float = 0.0,
    filename: str | None = None,
    fmt: str = "png",
):
    """Wireframe ellipsoids (one per Gaussian, radius = n_std * sigma)
    of a grid GMM (parity: `visualization.py:86-113`).

    `gmm` is an `ops.gmm.GridGMM` (or anything with w/mu/sigma arrays).
    """
    check_fmt(fmt)
    w, mu, sigma = (
        np.asarray(gmm.weights),
        np.asarray(gmm.means),
        np.asarray(gmm.sigma),
    )
    if ax is None:
        fig = figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
    sx, sy, sz = unit_sphere()
    for k in range(mu.shape[0]):
        if w[k] <= weight_threshold:
            continue
        ax.plot_wireframe(
            mu[k, 0] + n_std * sigma[k, 0] * sx,
            mu[k, 1] + n_std * sigma[k, 1] * sy,
            mu[k, 2] + n_std * sigma[k, 2] * sz,
            color="steelblue",
            alpha=0.15,
            linewidth=0.4,
        )
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_zlim(-1, 1)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def visualize_fv_with_pc(
    fv: np.ndarray,
    points: np.ndarray,
    *,
    resolution: int | None = None,
    n_scales: int = 1,
    filename: str | None = None,
    fmt: str = "png",
    fig_title: str = "patch + 3DmFV",
):
    """One patch and its statistics side by side
    (parity: `visualization.py:378-495`)."""
    check_fmt(fmt)
    fv = np.asarray(fv)
    points = np.asarray(points)
    if fv.ndim == 1:
        fv = fv.reshape(20 * n_scales, -1)
    C, K = fv.shape
    if resolution is None:
        resolution = int(round(K ** (1.0 / 3.0)))
    fig = figure(figsize=(12, 4))
    fig.suptitle(fig_title)
    ax_pc = fig.add_subplot(1, 2, 1, projection="3d")
    ax_pc.scatter(points[:, 0], points[:, 1], points[:, 2], s=3, c="k")
    ax_pc.set_xlim(-1, 1)
    ax_pc.set_ylim(-1, 1)
    ax_pc.set_zlim(-1, 1)
    ax_fv = fig.add_subplot(1, 2, 2)
    peak = np.max(np.abs(fv), axis=1, keepdims=True)
    img = fv / np.where(peak == 0, 1.0, peak)
    im = ax_fv.imshow(img, aspect="auto", cmap="seismic", vmin=-1, vmax=1)
    ax_fv.set_ylabel("channel")
    ax_fv.set_xlabel(f"Gaussian (K = {resolution}^3)")
    fig.colorbar(im, ax=ax_fv, fraction=0.03)
    if filename:
        fig.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return fig


def visualize_derivatives(
    points: np.ndarray,
    gmm,
    gaussian_index: int,
    *,
    filename: str | None = None,
    fmt: str = "png",
):
    """Per-point contribution magnitudes (|d_pi|, |d_mu|, |d_sigma|) to
    one Gaussian's statistics (parity: `visualization.py:563-627`).
    Computed from the soft assignment on the host."""
    from ..ops.mups import soft_assignment_np

    check_fmt(fmt)
    points = np.asarray(points, dtype=np.float64)
    w = np.asarray(gmm.weights)[gaussian_index]
    mu = np.asarray(gmm.means)[gaussian_index]
    sigma = np.asarray(gmm.sigma)[gaussian_index]
    q = soft_assignment_np(points, gmm)[:, gaussian_index]

    scaled = (points - mu) / sigma
    d_pi = np.abs(q - w) / np.sqrt(w)
    d_mu = np.linalg.norm(q[:, None] * scaled, axis=1) / np.sqrt(w)
    d_sig = np.linalg.norm(
        q[:, None] * (scaled ** 2 - 1.0), axis=1
    ) / np.sqrt(2 * w)

    fig = figure(figsize=(14, 4))
    for i, (vals, name) in enumerate(
        [(d_pi, r"$|d_\pi|$"), (d_mu, r"$\|d_\mu\|$"), (d_sig, r"$\|d_\sigma\|$")]
    ):
        ax = fig.add_subplot(1, 3, i + 1, projection="3d")
        sc = ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=vals,
                        s=4, cmap="jet")
        ax.set_title(name)
        fig.colorbar(sc, ax=ax, fraction=0.03)
    if filename:
        fig.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return fig


def draw_gaussian_points(
    points: np.ndarray,
    gmm,
    gaussian_index: int,
    *,
    ax=None,
    filename: str | None = None,
    fmt: str = "png",
    cmap: str = "jet",
):
    """Scatter a patch colored by its soft-assignment responsibility to
    one Gaussian (parity: `visualization.py:114-149`)."""
    from ..ops.mups import soft_assignment_np

    check_fmt(fmt)
    points = np.asarray(points)
    q = soft_assignment_np(points, gmm)[:, gaussian_index]
    if ax is None:
        fig = figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
    sc = ax.scatter(
        points[:, 0], points[:, 1], points[:, 2], c=q, s=4, cmap=cmap
    )
    ax.figure.colorbar(sc, ax=ax, fraction=0.03, label="responsibility")
    mu = np.asarray(gmm.means)[gaussian_index]
    ax.scatter([mu[0]], [mu[1]], [mu[2]], c="k", s=40, marker="x")
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax
