"""Fast np.savetxt-compatible text output (ctypes -> csrc/textio.cpp).

A copy of `nestinet_tpu/core/textio.py` that builds the port's own copy
of the C++ source into the gitignored `nestinet_tpu_torch/_build/`.

The serving result files are plain text for parity with the reference
(`test_n_est_w_experts.py:188-196` writes `.normals` etc. via
np.savetxt).  np.savetxt's per-row Python loop costs ~35 ms per 1024
patches on the 1-core serving host — on the critical path even behind
`AsyncShapeWriter`, because one core means the worker thread's GIL time
is stolen from the serving loop.  `savetxt` here formats with C
snprintf (~10x faster) and is byte-identical to np.savetxt for the two
formats the writers use (default "%.18e" float tables and "%i" integer
columns) — asserted in tests/test_textio.py.  Falls back to np.savetxt
when no compiler is available, like data/native.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "textio.cpp")
_LIB = os.path.join(_PKG, "_build", "libtextio.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _build_library() -> bool:
    """Compile into a per-process temporary name, then rename it into
    place, so concurrent processes never load a half-written library."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    for extra in (["-march=native"], []):
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", *extra,
                 _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _LIB)
            return True
        except Exception:
            continue
    return False


def get_library():
    """The loaded ctypes library, building it if needed; None when a
    compiler is unavailable (callers fall back to np.savetxt)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
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
        lib.write_table_f64.restype = ctypes.c_int
        lib.write_table_f64.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.write_table_i64.restype = ctypes.c_int
        lib.write_table_i64.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def savetxt(path: str, arr: np.ndarray, fmt: str = "%.18e") -> None:
    """np.savetxt(path, arr, fmt) with C-speed formatting.

    Supports exactly the writers' two cases — float tables at the
    np.savetxt default "%.18e" and integer columns at "%i" — and
    delegates anything else (or a failed native build/write) to
    np.savetxt.  Output bytes are identical either way.
    """
    a = np.asarray(arr)
    lib = get_library()
    if lib is not None and a.ndim in (1, 2):
        if fmt == "%.18e" and a.dtype == np.float64:
            a2 = np.ascontiguousarray(a if a.ndim == 2 else a[:, None])
            rc = lib.write_table_f64(
                path.encode(),
                a2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                a2.shape[0], a2.shape[1],
            )
            if rc == 0:
                return
        elif fmt == "%i" and a.ndim == 1 and a.dtype == np.int64:
            a1 = np.ascontiguousarray(a)
            rc = lib.write_table_i64(
                path.encode(),
                a1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                a1.shape[0],
            )
            if rc == 0:
                return
    np.savetxt(path, arr, fmt=fmt)
