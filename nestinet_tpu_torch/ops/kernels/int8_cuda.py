"""ctypes wrapper of the fused int8 implicit-GEMM conv kernel
(`csrc/int8_conv.cu`).

`int8_conv3d_cuda` is the counterpart of JAX's `conv_nd_int8` and
`linear_int8` (`nestinet_tpu/ops/quant.py:85-163`) together with the
quantize pass in front of them and, on request, the ReLU and the max|y|
after them: it takes the bfloat16 activation and the float32 bound its
scale comes from, and quantizes on load.  It checks what it is given,
allocates the outputs with `torch.empty` / `torch.zeros`, picks the output
tile from the shape (`tile_shape`), launches on the current stream and
raises on a launch error.  It never falls back: a tensor that is not on the
card, or not of the dtype, shape, contiguity and alignment the kernel
takes, raises.  `KERNEL.launches["int8_conv3d"]` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import CudaKernel, require_tensor

KERNEL = CudaKernel("int8_conv", ("int8_conv3d",))

# The longest reduction whose int32 sum cannot overflow: 127^2 * K < 2^31.
MAX_K = (2**31 - 1) // (127 * 127)
MAX_TAPS = 343  # k <= 7


def valid_cin_p(cin_p: int) -> bool:
    """The packed channel counts the kernels take: 16, 32, 64 or a multiple
    of 128, so that every K tile (64 or 128 bytes) holds whole taps or one
    slice of a tap."""
    return cin_p in (16, 32, 64) or (cin_p > 0 and cin_p % 128 == 0)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_shape(M: int, cout: int, sms: int) -> tuple[int, int]:
    """(BM, BN) of the output tile for M positions and cout channels on a
    card of `sms` SMs: the widest tile (128 x the smallest of 32/64/128 that
    covers cout) while it gives at least one block per SM, else narrower, BM
    first, so that small M (a routed sub-batch, an FC layer) still spreads
    over the card."""
    bm = 128
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128

    def blocks(bm, bn):
        return -(-M // bm) * -(-cout // bn)

    while blocks(bm, bn) < sms:
        if bm > 64:
            bm = 64
        elif bn > 32:
            bn //= 2
        else:
            break
    return bm, bn


def _bind(lib):
    fn = lib.int8_conv3d_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def int8_conv3d_cuda(x, w_q, s_w, b, kernel: int, x_amax, *, relu: bool = False,
                     want_amax: bool = False):
    """x bfloat16 [B, C, D, H, W], w_q int8 [cout, k^3, cin_p], s_w, b
    float32 [cout], x_amax float32 [] (the bound the scale comes from) ->
    (bfloat16 [B, cout, D, H, W], float32 [] max|out| or None), on the card.
    The scale is max(x_amax, 1e-12) / 127; `relu` applies ReLU to the
    bfloat16 outputs; `want_amax` returns max|out| of what it wrote."""
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on CUDA tensors, got {x.device}")
    if x.dim() != 5:
        raise ValueError(f"x must be [B, C, D, H, W], got {tuple(x.shape)}")
    B, C, D, H, W = x.shape
    k = int(kernel)
    cout, _, cin_p = w_q.shape
    dev = x.device
    if not valid_cin_p(cin_p) or not 0 < C <= cin_p:
        raise ValueError(f"need cin_p in 16, 32, 64 or a multiple of 128 and 0 < C <= "
                         f"cin_p, got C = {C}, cin_p = {cin_p}")
    if not 0 < k ** 3 <= MAX_TAPS:
        raise ValueError(f"kernel {k} is out of range")
    if k ** 3 * cin_p > MAX_K:
        raise ValueError(f"K = {k ** 3 * cin_p} could overflow the int32 sums (at most {MAX_K})")
    require_tensor(x, "x", torch.bfloat16, (B, C, D, H, W), dev)
    require_tensor(w_q, "w_q", torch.int8, (cout, k ** 3, cin_p), dev)
    require_tensor(s_w, "s_w", torch.float32, (cout,), dev)
    require_tensor(b, "b", torch.float32, (cout,), dev)
    require_tensor(x_amax, "x_amax", torch.float32, (), dev)
    for name, t in (("x", x), ("w_q", w_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((B, cout, D, H, W), dtype=torch.bfloat16, device=dev)
    amax = torch.zeros((), dtype=torch.float32, device=dev) if want_amax else None
    if B == 0:
        return out, amax
    bm, bn = tile_shape(B * D * H * W, cout, sm_count(dev.index))
    args = (x.data_ptr(), w_q.data_ptr(), x_amax.data_ptr(), s_w.data_ptr(), b.data_ptr(),
            out.data_ptr(), 0 if amax is None else amax.data_ptr(), int(bool(relu)),
            B, C, D, H, W, cin_p, cout, k, (k - 1) // 2, bm, bn)
    fn = _bind(KERNEL.lib())
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.check(code)
    KERNEL.launches["int8_conv3d"] += 1
    return out, amax
