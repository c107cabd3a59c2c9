"""Normal-field coloring and the spherical domain, in NumPy.

Copies of `nestinet_tpu/viz/normals.py::euclidean_to_spherical` (`:16`)
and `normal2rgb` (`:29`); the module's plots (`draw_phi_theta_domain`,
`draw_line_segments`, `visualize_pc_normals`, `discrete_cmap`) draw with
matplotlib and are not ported.
"""

from __future__ import annotations

import numpy as np


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
