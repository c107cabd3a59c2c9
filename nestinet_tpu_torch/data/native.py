"""ctypes bindings for the native C++ patch-sampling engine.

A copy of `nestinet_tpu/data/native.py` that builds the port's own copy
of the C++ source into the gitignored `nestinet_tpu_torch/_build/`.

The engine (csrc/patch_sampler.cpp) moves the per-patch hot loop —
kd-tree ball query, random subsample, pad, center, 1/radius scale — out
of Python into OpenMP-parallel C++.  The library is built on demand with
g++ (no extra Python deps); everything degrades gracefully to the
scipy/numpy path in `data/dataset.py` when a compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "patch_sampler.cpp")
_LIB = os.path.join(_PKG, "_build", "libpatchsampler.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _build_library() -> bool:
    """Compile into a per-process temporary name, then rename it into
    place, so concurrent processes never load a half-written library."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    for cmd in (
        ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
         "-std=c++17", _SRC, "-o", tmp],
        # retry without -march/-fopenmp for maximal portability
        ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp],
    ):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
            return True
        except Exception:
            continue
    return False


def get_library():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.isfile(_LIB) or (
            os.path.isfile(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build_library():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _build_failed = True
            return None
        lib.pk_build.restype = ctypes.c_void_p
        lib.pk_build.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.pk_free.argtypes = [ctypes.c_void_p]
        lib.pk_count_ball.restype = ctypes.c_int64
        lib.pk_count_ball.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_float,
        ]
        lib.pk_sample_patches.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_library() is not None


_CENTER_MODES = {"point": 0, "mean": 1, "none": 2}


class NativePatchSampler:
    """Per-shape native sampler; holds the C++ kd-tree handle."""

    def __init__(self, points: np.ndarray):
        lib = get_library()
        if lib is None:
            raise RuntimeError("native patch sampler unavailable")
        self._lib = lib
        self._pts = np.ascontiguousarray(points, dtype=np.float32)
        self._handle = lib.pk_build(
            self._pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._pts.shape[0],
        )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.pk_free(handle)
            self._handle = None

    def count_ball(self, center: np.ndarray, radius: float) -> int:
        center = np.ascontiguousarray(center, dtype=np.float32)
        return int(
            self._lib.pk_count_ball(
                self._handle,
                center.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_float(radius),
            )
        )

    def sample_patches(
        self,
        center_indices: np.ndarray,
        radii,
        points_per_patch: int,
        *,
        seed: int = 0,
        center: str = "point",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched patch extraction.

        Returns (points [B, n_rads * N, 3] float32 zero-padded,
                 n_eff [B, n_rads] int32).
        """
        center_indices = np.ascontiguousarray(center_indices, dtype=np.int64)
        radii_arr = np.ascontiguousarray(radii, dtype=np.float32)
        b = center_indices.shape[0]
        n_rads = radii_arr.shape[0]
        out = np.empty((b, n_rads * points_per_patch, 3), dtype=np.float32)
        neff = np.empty((b, n_rads), dtype=np.int32)
        self._lib.pk_sample_patches(
            self._handle,
            center_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b,
            radii_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_rads,
            points_per_patch,
            ctypes.c_uint64(seed),
            _CENTER_MODES[center],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            neff.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out, neff
