"""Point-cloud <-> voxel-volume helpers.

A copy of `nestinet_tpu/data/pointcloud.py` (numpy only), so that the port
imports nothing of the JAX package.

Capability parity with `utils/pc_util.py` (the reference's helper module
carried over from PointNet): voxelization of clouds for volumetric
baselines, de-voxelization, and simple image projections for quick
visual sanity checks.  Vectorized numpy; not on the training hot path.
"""

from __future__ import annotations

import numpy as np


def point_cloud_to_volume(points: np.ndarray, vsize: int, radius: float = 1.0):
    """Occupancy volume [vsize]^3 from a cloud assumed inside the sphere
    of `radius` (parity: `pc_util.py:42-55`)."""
    vol = np.zeros((vsize, vsize, vsize), dtype=np.float32)
    voxel = 2 * radius / float(vsize)
    locations = (points + radius) / voxel
    locations = np.clip(locations.astype(int), 0, vsize - 1)
    vol[locations[:, 0], locations[:, 1], locations[:, 2]] = 1.0
    return vol


def point_cloud_to_volume_batch(point_clouds: np.ndarray, vsize: int,
                                radius: float = 1.0, flatten: bool = True):
    """Batch voxelization (parity: `pc_util.py:25-39`)."""
    vols = np.stack(
        [point_cloud_to_volume(pc, vsize, radius) for pc in point_clouds]
    )
    if flatten:
        return vols.reshape(vols.shape[0], -1)
    return vols[..., None]


def volume_to_point_cloud(vol: np.ndarray) -> np.ndarray:
    """Occupied voxel centers as an [M, 3] cloud
    (parity: `pc_util.py:58-70`)."""
    assert vol.ndim == 3
    idx = np.argwhere(vol > 0)
    return idx.astype(np.float32)


def point_cloud_three_views(points: np.ndarray, img_size: int = 128) -> np.ndarray:
    """Concatenated xy/yz/xz orthographic density images
    (functional parity with `pc_util.py:100-160`'s quick renders)."""
    views = []
    for a, b in ((0, 1), (1, 2), (0, 2)):
        img = np.zeros((img_size, img_size), dtype=np.float32)
        pts = points[:, [a, b]]
        lo, hi = pts.min(0), pts.max(0)
        span = np.where(hi - lo == 0, 1.0, hi - lo)
        pix = ((pts - lo) / span * (img_size - 1)).astype(int)
        np.add.at(img, (pix[:, 0], pix[:, 1]), 1.0)
        if img.max() > 0:
            img /= img.max()
        views.append(img)
    return np.concatenate(views, axis=1)
