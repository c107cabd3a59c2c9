"""ctypes wrapper of the int8 implicit-GEMM conv kernel (`csrc/int8_conv.cu`).

`int8_conv3d_cuda` is the counterpart of the int8 convolution and dot that
`nestinet_tpu/ops/quant.py::conv_nd_int8` and `linear_int8` hand to XLA.
It checks what it is given, allocates the output with `torch.empty`,
launches on the current stream and raises on a launch error.  It never
falls back: a tensor that is not on the card, or not of the dtype, shape,
contiguity and alignment the kernel takes, raises.
`KERNEL.launches["int8_conv3d"]` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, require_tensor

KERNEL = CudaKernel("int8_conv", ("int8_conv3d",))

# The longest reduction whose int32 sum cannot overflow: 127^2 * K < 2^31.
MAX_K = (2**31 - 1) // (127 * 127)


def _bind(lib):
    fn = lib.int8_conv3d_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def int8_conv3d_cuda(x_q, w_q, s_w, s_x, b, kernel: int) -> torch.Tensor:
    """x_q [B, D, H, W, cin_p] int8, w_q [cout, k^3, cin_p] int8, s_w [cout],
    s_x [], b [cout] float32 -> bfloat16 [B, cout, D, H, W], on the card;
    cin_p a multiple of 16."""
    if x_q.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on CUDA tensors, got {x_q.device}")
    if x_q.dim() != 5:
        raise ValueError(f"x_q must be [B, D, H, W, cin_p], got {tuple(x_q.shape)}")
    B, D, H, W, cin_p = x_q.shape
    k = int(kernel)
    cout = w_q.shape[0]
    dev = x_q.device
    if k <= 0 or cin_p <= 0 or cin_p % 16 != 0:
        raise ValueError(f"need kernel > 0 and cin_p a positive multiple of 16, got "
                         f"{k} and {cin_p}")
    if k ** 3 * cin_p > MAX_K:
        raise ValueError(f"K = {k ** 3 * cin_p} could overflow the int32 sums (at most {MAX_K})")
    require_tensor(x_q, "x_q", torch.int8, (B, D, H, W, cin_p), dev)
    require_tensor(w_q, "w_q", torch.int8, (cout, k ** 3, cin_p), dev)
    require_tensor(s_w, "s_w", torch.float32, (cout,), dev)
    require_tensor(s_x, "s_x", torch.float32, (), dev)
    require_tensor(b, "b", torch.float32, (cout,), dev)
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((B, cout, D, H, W), dtype=torch.bfloat16, device=dev)
    if B == 0:
        return out
    fn = _bind(KERNEL.lib())
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        code = fn(
            x_q.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
            b.data_ptr(), out.data_ptr(), B, D, H, W, cin_p, cout, k, (k - 1) // 2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    KERNEL.check(code)
    KERNEL.launches["int8_conv3d"] += 1
    return out
