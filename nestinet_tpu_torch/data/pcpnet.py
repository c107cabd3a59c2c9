"""PCPNet-format shape IO.

The serving part of `nestinet_tpu/data/pcpnet.py` (points and `.pidx`,
no training targets), copied so that the port imports nothing of the JAX
package.

File conventions (parity with `utils/pcpnet_dataset.py:13-39, 248-270`):
    <shape>.xyz       Nx3 points, whitespace text
    <shape>.pidx      sparse evaluation indices (one per line)
    <list>.txt        shape names, one per line

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
    pidx: np.ndarray | None = None
    native: object = None  # NativePatchSampler when the C++ engine is on

    @property
    def bbox_diag(self) -> float:
        return float(np.linalg.norm(self.pts.max(0) - self.pts.min(0)))


def load_shape(root: str, name: str, *, with_pidx: bool = False) -> Shape:
    pts = _load_cached(os.path.join(root, name + ".xyz"), np.float32)
    pidx = (
        _load_cached(os.path.join(root, name + ".pidx"), np.int64)
        if with_pidx
        else None
    )
    return Shape(pts=pts, kdtree=spatial.cKDTree(pts, 10), pidx=pidx)


def read_shape_list(root: str, list_filename: str) -> list[str]:
    with open(os.path.join(root, list_filename)) as f:
        names = [x.strip() for x in f.readlines()]
    return [x for x in names if x]
