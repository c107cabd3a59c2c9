"""Build the port's CUDA kernels with nvcc at first use and load them.

Libraries: `csrc/mups_kernel.cu` (the two MuPS kernels, `mups_cuda.py`),
`csrc/int8_conv.cu` (the fused int8 implicit-GEMM convs, k > 1) and
`csrc/int8_gemm.cu` (the int8 GEMM of the k = 1 layers), both bound by
`int8_cuda.py` and both finding libcuda's `cuTensorMapEncodeTiled` with
dlopen; the int8 sources share `csrc/hopper.cuh`; `csrc/max_pool.cu` (the
backbones' max pool) and `csrc/avg_pool.cu` (the Inception blocks' average
pool), both bound by `pool_cuda.py`.  Each `csrc/<name>.cu`
exposes a plain C interface and is compiled on its own into a shared
library for sm_90a (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -ldl -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in `nestinet_tpu_torch/_build/` (listed in .gitignore),
named by a hash of the source, the headers of `csrc/` and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
Only sources in the package are built.  A failed build raises; nothing
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-ldl",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def require_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device`: what a kernel wrapper checks before it launches."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class CudaKernel:
    """One `csrc/<name>.cu` library: built and loaded at first use.

    `launches[kernel]` counts the launches of each kernel the library
    holds; the wrapper of a kernel adds one where it launches it, and
    nowhere else.
    """

    def __init__(self, name: str, kernels: tuple[str, ...]):
        self.name = name
        self.source = os.path.join(CSRC_DIR, name + ".cu")
        self.launches = dict.fromkeys(kernels, 0)
        self.ptxas_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> str:
        digest = hashlib.sha256()
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        for path in [self.source] + [os.path.join(CSRC_DIR, h) for h in headers]:
            with open(path, "rb") as f:
                digest.update(f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"{self.name}-{digest.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile the source unless a library of the same hash exists."""
        path = self.library_path()
        if os.path.isfile(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.source}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
        self.ptxas_log = proc.stdout + proc.stderr
        return path

    def lib(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                lib.cuda_error_string.argtypes = [ctypes.c_int]
                lib.cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def reset_launches(self) -> None:
        for kernel in self.launches:
            self.launches[kernel] = 0

    def check(self, code: int) -> None:
        """Raise on a non-zero CUDA error code returned by a launch."""
        if code != 0:
            msg = self.lib().cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({code}): {msg}")


def build_all(kernels) -> list[str]:
    """Build several libraries at once, one nvcc per source, all started
    together; returns their paths and raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        return list(pool.map(CudaKernel.build, kernels))
