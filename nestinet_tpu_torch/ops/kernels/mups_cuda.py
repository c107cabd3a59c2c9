"""ctypes wrappers of the MuPS CUDA kernels (`csrc/mups_kernel.cu`).

`tdmfv_n_est_cuda` is the counterpart of
`nestinet_tpu/ops/pallas/mups_kernel.py::_forward` (one row per ticket);
`tdmfv_n_est_blocked_cuda` the counterpart of
`scripts/mups_kernel_exp.py::forward_blocked` (`block_b` rows per ticket).
Both kernels run a persistent grid whose blocks take tickets from a counter
of two int32s; the kernel leaves it at 0, so one zeroed counter per (card,
stream) serves every launch on that stream.  Each wrapper checks what it is
given, allocates the output with `torch.empty`, launches on the current
stream and raises on a launch error.
They never fall back: a tensor that is not a contiguous float32 CUDA tensor
raises.  `KERNEL.launches["tdmfv_n_est"]` and
`KERNEL.launches["tdmfv_n_est_blocked"]` count their launches apart.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, require_tensor

N_CHANNELS = 20

KERNEL = CudaKernel("mups_kernel", ("tdmfv_n_est", "tdmfv_n_est_blocked"))

_TICKETS: dict = {}  # (device, stream) -> the zeroed ticket counter


def _tickets(dev: torch.device, stream) -> torch.Tensor:
    """The ticket counter of launches on `stream`: zeroed once, when it is
    made, and left at 0 by every launch that ran to its end."""
    key = (dev.index, stream.cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def _bind(lib, name: str, n_ints: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _checked(points, w, mu, sigma, n_eff):
    """Validate the kernels' inputs; returns (R, N, K)."""
    if points.device.type != "cuda":
        raise ValueError(f"the MuPS kernel runs on CUDA tensors, got {points.device}")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [R, N, 3], got {tuple(points.shape)}")
    R, N, _ = points.shape
    K = mu.shape[0]
    dev = points.device
    require_tensor(points, "points", torch.float32, (R, N, 3), dev)
    require_tensor(w, "w", torch.float32, (K,), dev)
    require_tensor(mu, "mu", torch.float32, (K, 3), dev)
    require_tensor(sigma, "sigma", torch.float32, (K, 3), dev)
    require_tensor(n_eff, "n_eff", torch.int32, (R,), dev)
    if not 0 < K <= 1024:
        raise ValueError(f"the MuPS kernel takes 1..1024 Gaussians, got {K}")
    if N <= 0:
        raise ValueError("points must hold at least one row per patch")
    return R, N, K


def _launch(kernel: str, points, w, mu, sigma, n_eff, *ints) -> torch.Tensor:
    R, N, K = points.shape[0], points.shape[1], mu.shape[0]
    dev = points.device
    out = torch.empty((R, N_CHANNELS, K), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    fn = _bind(KERNEL.lib(), kernel + "_launch", 3 + len(ints))
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        stream = torch.cuda.current_stream(dev)
        code = fn(
            points.data_ptr(), n_eff.data_ptr(), w.data_ptr(), mu.data_ptr(),
            sigma.data_ptr(), out.data_ptr(), _tickets(dev, stream).data_ptr(),
            R, N, K, *ints, stream.cuda_stream,
        )
    KERNEL.check(code)
    KERNEL.launches[kernel] += 1
    return out


def tdmfv_n_est_cuda(
    points: torch.Tensor,
    w: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    n_eff: torch.Tensor,
) -> torch.Tensor:
    """[R, N, 3] f32 points, [R] i32 n_eff -> [R, 20, K] f32, on the card;
    one row per ticket."""
    _checked(points, w, mu, sigma, n_eff)
    return _launch("tdmfv_n_est", points, w, mu, sigma, n_eff)


def tdmfv_n_est_blocked_cuda(
    points: torch.Tensor,
    w: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    n_eff: torch.Tensor,
    block_b: int,
) -> torch.Tensor:
    """The same statistics with `block_b` consecutive rows per ticket; R must
    be a multiple of `block_b`.  Bit-identical to `tdmfv_n_est_cuda`."""
    R, _, _ = _checked(points, w, mu, sigma, n_eff)
    if block_b <= 0 or R % block_b != 0:
        raise ValueError(f"{R} rows do not divide into blocks of {block_b}")
    return _launch("tdmfv_n_est_blocked", points, w, mu, sigma, n_eff, int(block_b))
