"""Point-cloud rendering: plain, scalar-overlay, expert and segmentation
clouds, the confusion matrix, and the per-shape export set.

The counterpart of `nestinet_tpu/viz/clouds.py`, drawn on the port's NumPy
canvas (`viz/canvas.py`) instead of matplotlib: the same functions,
parameters and defaults, the same limits, marker colors and positions.
Figures are written as PNG only (`fmt` other than "png" raises
ValueError: the canvas has no vector backend).
"""

from __future__ import annotations

import os

import numpy as np

from .canvas import check_fmt, figure, subplots
from .colors import discrete_cmap
from .normals import normal2rgb


def _scatter3(points, colors, *, ax=None, s=1.5, cmap=None, vmin=None, vmax=None):
    if ax is None:
        fig = figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
    sc = ax.scatter(
        points[:, 0], points[:, 1], points[:, 2],
        c=colors, s=s, cmap=cmap, vmin=vmin, vmax=vmax,
    )
    ax.set_axis_off()
    ax.set_box_aspect((1, 1, 1))
    return ax, sc


def normalize_to_unit_sphere(points: np.ndarray) -> np.ndarray:
    """Center and scale a cloud into the unit sphere (the MATLAB export
    pipeline's framing, `export_visualizations.m`)."""
    points = np.asarray(points, dtype=np.float64)
    points = points - points.mean(axis=0)
    r = np.max(np.linalg.norm(points, axis=1))
    return points / (r if r > 0 else 1.0)


def confusion_counts(y_true, y_pred, normalize: bool = False) -> np.ndarray:
    """[n, n] float64 counts of (true, predicted) label pairs, n = the
    largest label + 1 (1 for no labels); with `normalize` each row divided
    by its sum (an empty row stays zero)."""
    y_true = np.asarray(y_true, dtype=int)
    y_pred = np.asarray(y_pred, dtype=int)
    n = int(max(y_true.max(), y_pred.max())) + 1 if y_true.size else 1
    cm = np.zeros((n, n), dtype=np.float64)
    np.add.at(cm, (y_true, y_pred), 1.0)
    if normalize:
        row = cm.sum(axis=1, keepdims=True)
        cm = cm / np.where(row == 0, 1.0, row)
    return cm


def draw_point_cloud(points, *, color="b", ax=None, filename=None, fmt="png",
                     vmin=0.0, vmax=1.0):
    """Plain 3D scatter (parity: `visualization.py:47-66`)."""
    check_fmt(fmt)
    cmap = "jet" if not isinstance(color, str) else None
    ax, _ = _scatter3(np.asarray(points), color, ax=ax, cmap=cmap,
                      vmin=vmin if cmap else None, vmax=vmax if cmap else None)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def visualize_pc_overlay(points, overlay, *, cmap="jet", vmin=0.0, vmax=90.0,
                         ax=None, filename=None, fmt="png", label="error [deg]"):
    """Cloud colored by a scalar overlay, e.g. per-point angular error
    (parity: `visualization.py:277-304`)."""
    check_fmt(fmt)
    ax, sc = _scatter3(
        np.asarray(points), np.asarray(overlay), ax=ax, cmap=cmap,
        vmin=vmin, vmax=vmax,
    )
    ax.figure.colorbar(sc, ax=ax, fraction=0.03, label=label)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def visualize_pc_experts(points, experts, n_experts: int = 7, *, ax=None,
                         filename=None, fmt="png"):
    """Cloud colored by winning-expert id with a discrete colormap
    (parity: the expert renders of `MATLAB/export_visualizations.m`)."""
    check_fmt(fmt)
    ax, sc = _scatter3(
        np.asarray(points), np.asarray(experts), ax=ax,
        cmap=discrete_cmap(n_experts), vmin=-0.5, vmax=n_experts - 0.5,
    )
    cb = ax.figure.colorbar(sc, ax=ax, fraction=0.03, ticks=range(n_experts))
    cb.set_label("expert")
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def visualize_pc_seg(points, seg, n_classes: int, *, ax=None, filename=None,
                     fmt="png", label="class"):
    """Cloud colored by discrete segmentation labels
    (parity: `visualization.py:226-250`)."""
    check_fmt(fmt)
    ax, sc = _scatter3(
        np.asarray(points), np.asarray(seg), ax=ax,
        cmap=discrete_cmap(n_classes), vmin=-0.5, vmax=n_classes - 0.5,
    )
    cb = ax.figure.colorbar(sc, ax=ax, fraction=0.03, ticks=range(n_classes))
    cb.set_label(label)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def visualize_pc_seg_diff(points, seg_gt, seg_pred, *, ax=None, filename=None,
                          fmt="png"):
    """Correct/incorrect label overlay: wrong points in red
    (parity: `visualization.py:251-276`)."""
    check_fmt(fmt)
    wrong = (np.asarray(seg_gt) != np.asarray(seg_pred)).astype(float)
    ax, _ = _scatter3(np.asarray(points), wrong, ax=ax, cmap="RdYlGn_r",
                      vmin=0.0, vmax=1.0)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax


def visualize_confusion_matrix(y_true, y_pred, *, classes=None,
                               normalize=False, ax=None, filename=None,
                               fmt="png", cmap="viridis"):
    """Confusion-matrix heatmap with counts annotated; returns (ax, cm)
    (parity: `visualization.py:496-537`, sklearn-free)."""
    check_fmt(fmt)
    cm = confusion_counts(y_true, y_pred, normalize)
    n = cm.shape[0]
    if ax is None:
        _, ax = subplots(figsize=(1.0 + 0.6 * n, 1.0 + 0.6 * n))
    im = ax.imshow(cm, cmap=cmap)
    ax.figure.colorbar(im, ax=ax, fraction=0.04)
    ticks = classes if classes is not None else list(range(n))
    ax.set_xticks(range(n), ticks, rotation=45)
    ax.set_yticks(range(n), ticks)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    thresh = cm.max() / 2.0 if cm.size else 0.0
    for i in range(n):
        for j in range(n):
            val = f"{cm[i, j]:.2f}" if normalize else f"{int(cm[i, j])}"
            ax.text(j, i, val, ha="center", va="center",
                    color="white" if cm[i, j] < thresh else "black",
                    fontsize=7)
    if filename:
        ax.figure.savefig(f"{filename}.{fmt}", dpi=150, bbox_inches="tight")
    return ax, cm


def export_shape_visualizations(
    points: np.ndarray,
    normals_gt: np.ndarray,
    normals_pred: np.ndarray,
    outdir: str,
    shape: str,
    *,
    experts: np.ndarray | None = None,
    n_experts: int = 7,
    angle_errors: np.ndarray | None = None,
    fmt: str = "png",
) -> list[str]:
    """Per-shape render set: GT normals, predicted normals, angular
    error, and (for MoE) winning expert — the Python absorption of
    `MATLAB/export_visualizations.m:14-19`.  Returns written paths."""
    check_fmt(fmt)
    os.makedirs(outdir, exist_ok=True)
    points = normalize_to_unit_sphere(points)
    written = []

    def save(ax, tag):
        path = os.path.join(outdir, f"{shape}_{tag}.{fmt}")
        ax.figure.savefig(path, dpi=150, bbox_inches="tight")
        written.append(path)

    ax, _ = _scatter3(points, normal2rgb(normals_gt))
    save(ax, "normals_gt")
    ax, _ = _scatter3(points, normal2rgb(normals_pred))
    save(ax, "normals_pred")
    if angle_errors is not None:
        ax = visualize_pc_overlay(points, angle_errors)
        save(ax, "error")
    if experts is not None:
        ax = visualize_pc_experts(points, experts, n_experts)
        save(ax, "experts")
    return written
