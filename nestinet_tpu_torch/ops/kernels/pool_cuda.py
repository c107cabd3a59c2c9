"""ctypes wrapper of the max pool kernel (`csrc/max_pool.cu`).

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
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

POOL = CudaKernel("max_pool", ("max_pool3d",))

# (W, kernel, stride) of the rows `max_pool3d_kernel` is instantiated for:
# the 8^3, 4^3 and 2^3 pools of the 8^3 backbones, CONV_NET_3G's 3^3 pool
# and TINY's pool on a 3^3 grid
FIXED_ROWS = ((8, 2, 2), (4, 2, 2), (2, 2, 2), (3, 2, 2), (3, 3, 2))
DTYPES = (torch.bfloat16, torch.float32)


def fixed_row(W: int, kernel: int, stride: int) -> bool:
    """Whether the kernel instantiated for whole rows takes rows of W cells
    at this kernel and stride; every other shape takes the kernel that reads
    element by element, with the same mapping of threads to output rows."""
    return (W, kernel, stride) in FIXED_ROWS


def pooled_size(size: int, stride: int) -> int:
    return -(-size // stride)


def max_pool3d_cuda(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """x [B, C, D, H, W] bfloat16 or float32, contiguous, on the card ->
    [B, C, ceil(D / s), ceil(H / s), ceil(W / s)], the SAME max pool."""
    if x.dtype not in DTYPES:
        raise TypeError(f"the max pool kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be [B, C, D, H, W], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"the max pool kernel runs on CUDA tensors, got {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    k, s = int(kernel), int(stride)
    if k <= 0 or s <= 0:
        raise ValueError(f"kernel {k} and stride {s} must be positive")
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
