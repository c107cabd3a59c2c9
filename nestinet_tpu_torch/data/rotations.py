"""Euler-angle / rotation-matrix / quaternion conversions.

A copy of `nestinet_tpu/data/rotations.py` (numpy only), so that the port
imports nothing of the JAX package.

Capability parity with the vendored `utils/eulerangles.py` (only
`euler2mat` is exercised by the reference trainers, for whole-batch
SO(3) rotation augmentation at `train_n_est_w_experts.py:268-279`).
Conventions match: intrinsic rotations applied z first, then y, then x
(`M = Mx @ My @ Mz` acting on column vectors).
"""

from __future__ import annotations

import math

import numpy as np


def euler2mat(z: float = 0.0, y: float = 0.0, x: float = 0.0) -> np.ndarray:
    """Rotation matrix for rotations around z, y, x axes (in that order)."""
    mats = []
    if z:
        c, s = math.cos(z), math.sin(z)
        mats.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))
    if y:
        c, s = math.cos(y), math.sin(y)
        mats.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    if x:
        c, s = math.cos(x), math.sin(x)
        mats.append(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
    if mats:
        # z is applied first => rightmost factor: M = Mx @ My @ Mz.
        m = mats[0]
        for nxt in mats[1:]:
            m = nxt @ m
        return m
    return np.eye(3)


def mat2euler(m, cy_thresh: float | None = None):
    """Inverse of euler2mat: returns (z, y, x)."""
    m = np.asarray(m)
    if cy_thresh is None:
        cy_thresh = np.finfo(m.dtype).eps * 4 if m.dtype.kind == "f" else 1e-6
    r11, r12, r13, r21, r22, r23, _, _, r33 = m.flat[:9]
    cy = math.sqrt(r33 * r33 + r23 * r23)
    if cy > cy_thresh:
        z = math.atan2(-r12, r11)
        y = math.atan2(r13, cy)
        x = math.atan2(-r23, r33)
    else:  # gimbal lock: cos(y) ~ 0
        z = math.atan2(r21, r22)
        y = math.atan2(r13, cy)
        x = 0.0
    return z, y, x


def euler2quat(z: float = 0.0, y: float = 0.0, x: float = 0.0) -> np.ndarray:
    """Quaternion (w, x, y, z) for the same rotation as euler2mat."""
    z, y, x = z / 2.0, y / 2.0, x / 2.0
    cz, sz = math.cos(z), math.sin(z)
    cy, sy = math.cos(y), math.sin(y)
    cx, sx = math.cos(x), math.sin(x)
    return np.array(
        [
            cx * cy * cz - sx * sy * sz,
            cx * sy * sz + cy * cz * sx,
            cx * cz * sy - sx * cy * sz,
            cx * cy * sz + sx * cz * sy,
        ]
    )


def quat2mat(q) -> np.ndarray:
    """Rotation matrix from quaternion (w, x, y, z)."""
    w, x, y, z = q
    nq = w * w + x * x + y * y + z * z
    if nq < np.finfo(np.float64).eps:
        return np.eye(3)
    s = 2.0 / nq
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def mat2quat(m) -> np.ndarray:
    """Quaternion (w, x, y, z) from rotation matrix (symmetric-K method)."""
    qxx, qyx, qzx, qxy, qyy, qzy, qxz, qyz, qzz = np.asarray(m).flat
    k = (
        np.array(
            [
                [qxx - qyy - qzz, 0, 0, 0],
                [qyx + qxy, qyy - qxx - qzz, 0, 0],
                [qzx + qxz, qzy + qyz, qzz - qxx - qyy, 0],
                [qyz - qzy, qzx - qxz, qxy - qyx, qxx + qyy + qzz],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q *= -1
    return q


def quat2euler(q):
    """(z, y, x) Euler angles from quaternion (w, x, y, z)
    (parity: `utils/eulerangles.py:315`)."""
    return mat2euler(quat2mat(q))


def euler2angle_axis(z: float = 0.0, y: float = 0.0, x: float = 0.0):
    """(theta, unit_vector) angle-axis form of the euler2mat rotation
    (parity: `utils/eulerangles.py:344`)."""
    w, vx, vy, vz = euler2quat(z, y, x)
    vec = np.array([vx, vy, vz])
    n = math.sqrt(float(vec @ vec))
    theta = 2.0 * math.atan2(n, w)
    if n < np.finfo(np.float64).eps:
        return 0.0, np.array([1.0, 0.0, 0.0])
    return theta, vec / n


def angle_axis2euler(theta: float, vector, is_normalized: bool = False):
    """(z, y, x) Euler angles from an angle-axis rotation
    (parity: `utils/eulerangles.py:378`)."""
    vec = np.asarray(vector, dtype=np.float64)
    if not is_normalized:
        n = math.sqrt(float(vec @ vec))
        if n < np.finfo(np.float64).eps:
            return 0.0, 0.0, 0.0
        vec = vec / n
    half = theta / 2.0
    q = np.concatenate([[math.cos(half)], math.sin(half) * vec])
    return mat2euler(quat2mat(q))


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """The trainer's whole-batch rotation: R^T of euler2mat on three
    normal-distributed angles scaled by 2*pi
    (parity: `train_n_est_w_experts.py:269-270`)."""
    angles = 2.0 * np.pi * rng.randn(3)
    return euler2mat(z=angles[0], y=angles[1], x=angles[2]).T
