"""Normal-field visualization: normals as RGB, the (phi, theta) domain
plots, GT -> prediction segments and the normal-colored cloud.

The counterpart of `nestinet_tpu/viz/normals.py`, drawn on the port's
NumPy canvas (`viz/canvas.py`) instead of matplotlib: the same functions,
parameters and defaults, the same limits, marker colors and positions.
Figures are written as PNG only (`fmt` other than "png" raises
ValueError: the canvas has no vector backend); `display` has no window to
show and is accepted and ignored.
"""

from __future__ import annotations

import numpy as np

from .canvas import Axes, check_fmt, figure, subplots
from .colors import discrete_cmap  # noqa: F401  (public here, as in the JAX module)


def euclidean_to_spherical(points: np.ndarray, degrees: bool = True):
    """xyz -> (phi, theta) on the unit sphere (ISO convention; parity:
    `utils/utils.py:332-353`)."""
    points = np.asarray(points)
    theta = np.arctan2(
        np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2), points[:, 2]
    )
    phi = np.arctan2(points[:, 1], points[:, 0])
    if degrees:
        phi, theta = np.rad2deg(phi), np.rad2deg(theta)
    return phi, theta


def normal2rgb(normals: np.ndarray) -> np.ndarray:
    """Map normals to RGB in [0, 1] (x,y,z -> r,g,b) after normalizing
    each; a zero normal maps to (0.5, 0.5, 0.5) (parity:
    `visualization.py:699-713`)."""
    normals = np.asarray(normals, dtype=np.float64)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    norm = np.where(norm == 0, 1.0, norm)
    return 0.5 * (normals / norm) + 0.5


def draw_phi_theta_domain(
    phi,
    theta,
    color="k",
    *,
    ax=None,
    title=None,
    cmap=None,
    n_labels=None,
    footnote=None,
    filename=None,
    fmt="png",
    display=False,
) -> Axes:
    """Scatter normals in the (phi, theta) domain; `color` may be an
    array (e.g. expert ids) with a discrete cmap (parity:
    `visualization.py:746-797`)."""
    check_fmt(fmt)
    if ax is None:
        _, ax = subplots(figsize=(8, 5))
    sc = ax.scatter(phi, theta, s=2, c=color, cmap=cmap)
    ax.set_xlabel(r"$\phi$ [deg]")
    ax.set_ylabel(r"$\theta$ [deg]")
    ax.set_xlim(-180, 180)
    ax.set_ylim(0, 180)
    if title:
        ax.set_title(title)
    if cmap is not None and n_labels is not None:
        cb = ax.figure.colorbar(sc, ax=ax, ticks=range(n_labels))
        cb.set_label("expert")
    if footnote:
        ax.annotate(footnote, xy=(0, -0.12), xycoords="axes fraction", fontsize=7)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def draw_line_segments(phi0, theta0, phi1, theta1, *, ax=None, filename=None,
                       fmt="png", footnote=None, display=False) -> Axes:
    """GT -> prediction line segments in the (phi, theta) domain, all drawn
    in one vectorised pass (parity: `visualization.py:798-841`)."""
    check_fmt(fmt)
    if ax is None:
        _, ax = subplots(figsize=(8, 5))
    ax.plot_segments(phi0, theta0, phi1, theta1, color="0.7", linewidth=0.5, zorder=0)
    if footnote:
        ax.annotate(footnote, xy=(0, -0.12), xycoords="axes fraction", fontsize=7)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def visualize_pc_normals(points, normals, *, filename=None, fmt="png"):
    """3D scatter of a cloud colored by normal2rgb
    (parity: `visualization.py:715-745`)."""
    check_fmt(fmt)
    fig = figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    points = np.asarray(points)
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1, c=normal2rgb(normals))
    ax.set_axis_off()
    if filename:
        fig.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax
