"""ctypes wrappers of the pool kernels (`csrc/max_pool.cu`, `csrc/avg_pool.cu`).

`max_pool3d_cuda` computes the backbones' 3-D max pool, TensorFlow's SAME
padding with a -inf pad, on a contiguous NCDHW bfloat16 or float32 CUDA
tensor, in one launch and without indices, bit for bit as
`ops/nn.py::max_pool3d_reference`.  JAX runs the pool as XLA's
`reduce_window` (`nestinet_tpu/ops/nn.py:347`), not as a Pallas kernel.
The row width W, kernel and stride choose the kernel (`fixed_row`, the one
place that chooses); the wrapper checks what it is given, allocates the
output with `torch.empty`, launches on the current stream and raises on a
launch error.  It never falls back: a tensor that is not on the card, or
not of the dtype, rank, contiguity and alignment the kernel takes, raises.
`POOL.launches["max_pool3d"]` counts its launches.

`avg_pool3d_cuda` computes the Inception block's separable average pool,
TensorFlow's SAME padding with TensorFlow's divisor (the window's cells
inside the grid) and optionally the pool branch's ReLU, in one launch, bit
for bit as `ops/nn.py::avg_pool3d_reference`; JAX runs it as XLA's
`reduce_window` (`nestinet_tpu/ops/nn.py:394-414`).  The volume, kernel
and stride choose the kernel (`fixed_volume`); the wrapper checks and
launches as the max pool's does.  `AVG_POOL.launches["avg_pool3d"]` counts
its launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

POOL = CudaKernel("max_pool", ("max_pool3d",))
AVG_POOL = CudaKernel("avg_pool", ("avg_pool3d",))
KERNELS = (POOL, AVG_POOL)

# (W, kernel, stride) of the rows `max_pool3d_kernel` is instantiated for:
# the 8^3, 4^3 and 2^3 pools of the 8^3 backbones, CONV_NET_3G's 3^3 pool
# and TINY's pool on a 3^3 grid
FIXED_ROWS = ((8, 2, 2), (4, 2, 2), (2, 2, 2), (3, 2, 2), (3, 3, 2))
# (R, kernel) of the cubic R^3 volumes `avg_pool3d_kernel` is instantiated for at
# stride 1: the served backbones' pools at 8^3 (k 3), 4^3 (k 2 and 3) and 2^3 (k 1
# and 2), CONV_NET_3G's at 3^3 (k 1 and 2) and TINY's at 8^3 (k 1)
FIXED_VOLUMES = ((8, 3), (8, 1), (4, 3), (4, 2), (2, 2), (2, 1), (3, 2), (3, 1))
DTYPES = (torch.bfloat16, torch.float32)


def fixed_row(W: int, kernel: int, stride: int) -> bool:
    """Whether the kernel instantiated for whole rows takes rows of W cells
    at this kernel and stride; every other shape takes the kernel that reads
    element by element, with the same mapping of threads to output rows."""
    return (W, kernel, stride) in FIXED_ROWS


def fixed_volume(size, kernel: int, stride: int) -> bool:
    """Whether the average pool kernel instantiated for whole volumes takes
    a grid of `size` (D, H, W) at this kernel and stride; every other shape
    takes the kernel that reads cell by cell, with the same arithmetic."""
    D, H, W = size
    return stride == 1 and D == H == W and (W, kernel) in FIXED_VOLUMES


def pooled_size(size: int, stride: int) -> int:
    return -(-size // stride)


def _checked(x: torch.Tensor, kernel: int, stride: int, what: str) -> tuple[int, int]:
    """Raise unless a pool kernel takes `x`; returns (kernel, stride)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"the {what} kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be [B, C, D, H, W], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    k, s = int(kernel), int(stride)
    if k <= 0 or s <= 0:
        raise ValueError(f"kernel {k} and stride {s} must be positive")
    return k, s


def max_pool3d_cuda(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """x [B, C, D, H, W] bfloat16 or float32, contiguous, on the card ->
    [B, C, ceil(D / s), ceil(H / s), ceil(W / s)], the SAME max pool."""
    k, s = _checked(x, kernel, stride, "max pool")
    B, C, D, H, W = x.shape
    OD, OH, OW = (pooled_size(n, s) for n in (D, H, W))
    if B * C * OD * OH >= 2**31:
        raise ValueError(f"{B * C * OD * OH} output rows: the kernel indexes them in 32 bits")
    out = torch.empty((B, C, OD, OH, OW), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = POOL.lib().max_pool3d_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):  # the launch goes to the tensor's card
        code = fn(x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), B * C, D, H, W,
                  k, s, int(fixed_row(W, k, s)), torch.cuda.current_stream(x.device).cuda_stream)
    POOL.check(code)
    POOL.launches["max_pool3d"] += 1
    return out


def avg_pool3d_cuda(x: torch.Tensor, kernel: int, stride: int, relu: bool = False) -> torch.Tensor:
    """x [B, C, D, H, W] bfloat16 or float32, contiguous, on the card ->
    [B, C, ceil(D / s), ceil(H / s), ceil(W / s)], the separable SAME
    average pool over the valid cells of each window, then max(out, 0)
    where `relu`."""
    k, s = _checked(x, kernel, stride, "average pool")
    B, C, D, H, W = x.shape
    out = torch.empty((B, C, *(pooled_size(n, s) for n in (D, H, W))), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = AVG_POOL.lib().avg_pool3d_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):  # the launch goes to the tensor's card
        code = fn(x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), B * C, D, H, W,
                  k, s, int(bool(relu)), int(fixed_volume((D, H, W), k, s)),
                  torch.cuda.current_stream(x.device).cuda_stream)
    AVG_POOL.check(code)
    AVG_POOL.launches["avg_pool3d"] += 1
    return out
