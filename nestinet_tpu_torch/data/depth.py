"""Real-scan ingestion: depth maps -> world-space point clouds, and
projecting per-point properties back into image space.

A NumPy copy of `nestinet_tpu/data/depth.py`, so that the port imports
nothing of the JAX package.  It absorbs the reference's MATLAB-only
real-scan path (parity: `MATLAB/ScanNet_depth2xyz.m:1-22` and
`MATLAB/ScanNet_world2cam_normals.m:1-21`), vectorized over the full
depth image instead of per-pixel loops, with the MATLAB quirks kept:
1-based pixel indices, the pose translation dropped unless
`apply_translation`, round half away from zero, and the pixels that
several points project to written by one NumPy fancy assignment in the
points' order, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def depth_to_xyz(
    depth_img: np.ndarray,
    intrinsic: np.ndarray,
    pose: np.ndarray,
    depth_shift: float = 1.0,
    apply_translation: bool = False,
) -> np.ndarray:
    """Unproject a depth image to world-space points.

    Args:
        depth_img: [H, W] depth values (0 = invalid).
        intrinsic: [4, 4] (or [3, 3]) camera intrinsic matrix.
        pose:      [4, 4] camera-to-world transform.
        depth_shift: depth scale divisor (e.g. 1000 for millimeter PNGs).
        apply_translation: the reference MATLAB uses a homogeneous 0 for
            the camera point (`ScanNet_depth2xyz.m:15`), so the pose
            TRANSLATION is silently dropped — only the rotation is
            applied.  False (default) preserves that behavior for
            parity; True applies the full rigid transform.

    Returns:
        [M, 3] world-space points for the M valid pixels, in the same
        row-major (y, x) order the MATLAB loop produced.
    """
    depth_img = np.asarray(depth_img)
    h, w = depth_img.shape
    intrinsic4 = np.eye(4)
    intrinsic4[: intrinsic.shape[0], : intrinsic.shape[1]] = intrinsic
    intrinsic_inv = np.linalg.inv(intrinsic4)

    ys, xs = np.nonzero(depth_img != 0)
    d = depth_img[ys, xs].astype(np.float64) / depth_shift
    # MATLAB used 1-based pixel indices; preserved for parity.
    px = (xs + 1).astype(np.float64)
    py = (ys + 1).astype(np.float64)

    homo = np.ones_like(d) if apply_translation else np.zeros_like(d)
    cam = np.stack([px * d, py * d, d, homo], axis=0)  # [4, M]
    world = pose @ (intrinsic_inv @ cam)
    pts = world[:3].T
    # drop all-zero rows like the MATLAB post-filter
    keep = np.any(pts != 0, axis=1)
    return pts[keep]


def world_to_image(
    points: np.ndarray,
    prop: np.ndarray,
    image_shape: tuple[int, int],
    intrinsic: np.ndarray,
    pose: np.ndarray,
) -> np.ndarray:
    """Project per-point properties (e.g. predicted normals) back to the
    image plane.

    Returns an [H, W, C] image; pixels with no projected point are zero.
    """
    points = np.asarray(points, dtype=np.float64)
    prop = np.asarray(prop)
    h, w = image_shape
    c = prop.shape[1]

    intrinsic4 = np.eye(4)
    intrinsic4[: intrinsic.shape[0], : intrinsic.shape[1]] = intrinsic
    world2cam = np.linalg.inv(pose)

    homo = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)  # [M,4]
    pix = (intrinsic4 @ world2cam @ homo.T)  # [4, M]
    pix = pix / pix[2]
    # MATLAB round(): half away from zero (np.rint would round .5 to even).
    x = np.floor(pix[0] + 0.5).astype(np.int64)
    y = np.floor(pix[1] + 0.5).astype(np.int64)
    # 1-based bounds as in MATLAB, converted to 0-based indexing.
    valid = (x > 0) & (y > 0) & (x <= w) & (y <= h)

    img = np.zeros((h, w, c), dtype=prop.dtype)
    img[y[valid] - 1, x[valid] - 1] = prop[valid]
    return img
