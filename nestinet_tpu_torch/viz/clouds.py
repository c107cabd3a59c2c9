"""Point-cloud framing and the confusion matrix's counts, in NumPy.

`normalize_to_unit_sphere` copies `nestinet_tpu/viz/clouds.py:45`, and
`confusion_counts` is the count matrix that its
`visualize_confusion_matrix` draws (`:127-134`), as a plain function.  The
module's renders (`draw_point_cloud`, `visualize_pc_*`, the heatmap,
`export_shape_visualizations`) draw with matplotlib and are not ported.
"""

from __future__ import annotations

import numpy as np


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
