"""PCPNet-format shape IO.

A copy of `nestinet_tpu/data/pcpnet.py` without the curvatures (no
ported model trains on them), so that the port imports nothing of the JAX
package.

File conventions (parity with `utils/pcpnet_dataset.py:13-39, 248-270`):
    <shape>.xyz       Nx3 points, whitespace text
    <shape>.normals   Nx3 ground-truth normals
    <shape>.pidx      sparse evaluation indices (one per line)
    <list>.txt        shape names, one per line
    <list>_noise_levels.txt   optional per-shape noise levels

Text files are converted to `.npy` sidecars on first touch (the
reference's caching trick) — subsequent loads are mmap-fast.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
from scipy import spatial


def _load_cached(path: str, dtype) -> np.ndarray:
    """Load `path` (text), caching as `<path>.npy`."""
    cache = path + ".npy"
    if os.path.isfile(cache) and os.path.getmtime(cache) >= os.path.getmtime(path):
        return np.load(cache)
    arr = np.loadtxt(path).astype(dtype)
    np.save(cache, arr)
    return arr


@dataclasses.dataclass
class Shape:
    pts: np.ndarray
    kdtree: spatial.cKDTree
    normals: np.ndarray | None = None
    pidx: np.ndarray | None = None
    noise_level: float = 0.0
    native: object = None  # NativePatchSampler when the C++ engine is on

    @property
    def bbox_diag(self) -> float:
        return float(np.linalg.norm(self.pts.max(0) - self.pts.min(0)))


def load_shape(root: str, name: str, *, with_normals: bool = False,
               with_pidx: bool = False, noise_level: float = 0.0) -> Shape:
    pts = _load_cached(os.path.join(root, name + ".xyz"), np.float32)
    normals = (
        _load_cached(os.path.join(root, name + ".normals"), np.float32)
        if with_normals
        else None
    )
    pidx = (
        _load_cached(os.path.join(root, name + ".pidx"), np.int64)
        if with_pidx
        else None
    )
    return Shape(pts=pts, kdtree=spatial.cKDTree(pts, 10), normals=normals, pidx=pidx,
                 noise_level=noise_level)


def read_shape_list(root: str, list_filename: str) -> list[str]:
    with open(os.path.join(root, list_filename)) as f:
        names = [x.strip() for x in f.readlines()]
    return [x for x in names if x]


def read_noise_levels(root: str, list_filename: str, n_shapes: int) -> list[float]:
    """Optional `<list>_noise_levels.txt` (parity: pcpnet_dataset.py:223-233)."""
    path = os.path.join(root, list_filename[:-4] + "_noise_levels.txt")
    if not os.path.exists(path):
        return [0.0] * n_shapes
    with open(path) as f:
        levels = [float(x.strip()) for x in f.readlines() if x.strip()]
    if len(levels) != n_shapes:
        raise ValueError(
            f"noise level file {path} has {len(levels)} entries for {n_shapes} shapes"
        )
    return levels
