"""Both packages' native patch samplers, loaded before a test compares them.

JAX's `nestinet_tpu/data/native.py` links `native/libpatchsampler.so` in
place with g++.  When several pytest workers start from a tree without the
library, one of them can find the file half linked: `ctypes.CDLL` fails, the
module caches `_build_failed = True` for the rest of its process, and from
then on that worker's JAX loader takes the scipy path while the port's
loader (which builds atomically into `nestinet_tpu_torch/_build/`) takes the
native one, so the two loaders' batches differ.

`load_jax_native()` repairs that in the test process, never in the JAX
package: under an `fcntl` lock on a file in the port's build directory it
loads JAX's library, and if that fails it waits for the other worker's
link, clears the cached failure and loads again; a library that stays
broken is relinked into a temporary name and renamed into place.  Every
port test that compares the port's host loader with JAX's calls it first.
"""

import fcntl
import os
import subprocess
import sys
import time

import numpy as np

from nestinet_tpu.data import native as jax_native
from nestinet_tpu_torch.data import native
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

LOCK_PATH = os.path.join(os.path.dirname(native._LIB), "jax_native.lock")
RETRIES = 8
RETRY_WAIT_S = 0.5


def _forget_failure() -> None:
    jax_native._build_failed = False
    jax_native._lib = None


def _relink() -> None:
    """Link JAX's source into a per-process name, then rename it over the
    library, as the port's own build does."""
    tmp = f"{jax_native._LIB}.{os.getpid()}.tmp"
    for cmd in (["g++", "-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
                 "-std=c++17", jax_native._SRC, "-o", tmp],
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", jax_native._SRC, "-o", tmp]):
        if subprocess.run(cmd, capture_output=True, timeout=120).returncode == 0:
            os.replace(tmp, jax_native._LIB)
            return


def load_jax_native() -> bool:
    """True once JAX's native sampler is loaded in this process (False only
    when no compiler can build it, and then neither package has one)."""
    os.makedirs(os.path.dirname(LOCK_PATH), exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for _ in range(RETRIES):
                if jax_native.get_library() is not None:
                    return True
                time.sleep(RETRY_WAIT_S)  # another worker may still be linking
                _forget_failure()
            _relink()
            _forget_failure()
            return jax_native.get_library() is not None
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def test_load_jax_native_clears_a_cached_failure():
    assert load_jax_native()
    saved = jax_native._lib
    jax_native._lib, jax_native._build_failed = None, True  # what the race leaves
    try:
        assert not jax_native.available()
        assert load_jax_native()
        assert jax_native.available() and native.available()
    finally:
        if jax_native._lib is None:
            jax_native._lib, jax_native._build_failed = saved, False


def test_load_jax_native_relinks_a_truncated_library(tmp_path, monkeypatch):
    """A half-linked file that no other process will finish: the helper
    relinks it (here a copy of JAX's paths, so the real library is never
    touched)."""
    lib = tmp_path / "libpatchsampler.so"
    lib.write_bytes(b"\x7fELF half")
    monkeypatch.setattr(jax_native, "_LIB", str(lib))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_build_failed", False)
    monkeypatch.setattr(sys.modules[__name__], "RETRIES", 2)
    monkeypatch.setattr(sys.modules[__name__], "RETRY_WAIT_S", 0.0)
    os.utime(lib, (time.time() + 60, time.time() + 60))  # newer than the source
    assert load_jax_native()
    assert lib.stat().st_size > 1000
    pts = np.random.RandomState(1).rand(200, 3).astype(np.float32)
    got = jax_native.NativePatchSampler(pts).sample_patches(np.arange(8), (0.3,), 12, seed=4)
    want = native.NativePatchSampler(pts).sample_patches(np.arange(8), (0.3,), 12, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
