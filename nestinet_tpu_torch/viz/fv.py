"""The unit-sphere mesh the Gaussians' ellipsoids are drawn from, in NumPy.

A copy of `nestinet_tpu/viz/fv.py::_unit_sphere` (`:88`); the module's
plots (`visualize_fv`, `draw_gaussians`, `draw_gaussian_points`) draw with
matplotlib and are not ported.
"""

from __future__ import annotations

import numpy as np


def unit_sphere(subdiv: int = 12):
    """Lat/long unit-sphere mesh: (x, y, z), each [subdiv, subdiv]
    (parity: `visualization.py:538-551`)."""
    u = np.linspace(0, 2 * np.pi, subdiv)
    v = np.linspace(0, np.pi, subdiv)
    x = np.outer(np.cos(u), np.sin(v))
    y = np.outer(np.sin(u), np.sin(v))
    z = np.outer(np.ones_like(u), np.cos(v))
    return x, y, z
