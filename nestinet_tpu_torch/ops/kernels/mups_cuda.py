"""ctypes wrapper of the MuPS CUDA kernel (`csrc/mups_kernel.cu`).

Counterpart of `nestinet_tpu/ops/pallas/mups_kernel.py::_forward`.  The
wrapper checks what it is given, allocates the output with `torch.empty`,
launches on the current stream and raises on a launch error.  It never
falls back: a tensor that is not a contiguous float32 CUDA tensor raises.
`KERNEL.launches` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

N_CHANNELS = 20

KERNEL = CudaKernel("mups_kernel")


def _bind(lib):
    fn = lib.tdmfv_n_est_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tdmfv_n_est_cuda(
    points: torch.Tensor,
    w: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    n_eff: torch.Tensor,
) -> torch.Tensor:
    """[R, N, 3] f32 points, [R] i32 n_eff -> [R, 20, K] f32, on the card."""
    if points.device.type != "cuda":
        raise ValueError(f"the MuPS kernel runs on CUDA tensors, got {points.device}")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [R, N, 3], got {tuple(points.shape)}")
    R, N, _ = points.shape
    K = mu.shape[0]
    dev = points.device
    _require(points, "points", torch.float32, (R, N, 3), dev)
    _require(w, "w", torch.float32, (K,), dev)
    _require(mu, "mu", torch.float32, (K, 3), dev)
    _require(sigma, "sigma", torch.float32, (K, 3), dev)
    _require(n_eff, "n_eff", torch.int32, (R,), dev)
    if not 0 < K <= 1024:
        raise ValueError(f"the MuPS kernel takes 1..1024 Gaussians, got {K}")
    if N <= 0:
        raise ValueError("points must hold at least one row per patch")
    out = torch.empty((R, N_CHANNELS, K), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    fn = _bind(KERNEL.lib())
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        code = fn(
            points.data_ptr(), n_eff.data_ptr(), w.data_ptr(), mu.data_ptr(),
            sigma.data_ptr(), out.data_ptr(), R, N, K,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    KERNEL.check(code)
    KERNEL.launches += 1
    return out
