"""ctypes wrappers of the fused int8 kernels: the implicit-GEMM convs
(`csrc/int8_conv.cu`, k > 1) and the GEMM of the k = 1 layers
(`csrc/int8_gemm.cu`, the 1x1x1 convs and the linears).

`int8_conv3d_cuda` is the counterpart of JAX's `conv_nd_int8` and
`linear_int8` (`nestinet_tpu/ops/quant.py:85-163`) together with the
quantize pass in front of them and, on request, the ReLU and the max|y|
after them: it takes the bfloat16 activation and the float32 bound its
scale comes from, and quantizes on load.  It checks what it is given,
allocates the outputs with `torch.empty` (the launcher zeroes max|out| on
the stream), names the kernel from the shape (`kernel_for`, the one place
that chooses) and its tiles (`tile_shape`, `gemm_plan`), launches on the
current stream and raises on a launch error.  It never falls back: a
tensor that is not on the card, or not of the dtype, shape, contiguity and
alignment the kernels take, raises.
`KERNEL.launches["int8_conv3d"]` counts the conv kernels' launches (direct
and gather), `GEMM.launches["int8_gemm"]` the GEMM's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import CudaKernel, require_tensor

KERNEL = CudaKernel("int8_conv", ("int8_conv3d",))
GEMM = CudaKernel("int8_gemm", ("int8_gemm",))
KERNELS = (KERNEL, GEMM)

# The longest reduction whose int32 sum cannot overflow: 127^2 * K < 2^31.
MAX_K = (2**31 - 1) // (127 * 127)
MAX_TAPS = 343  # k <= 7
GEMM_BM = 128  # rows of the GEMM's tile
GEMM_BK = 64  # channels of one of its K stages
MAX_SPLITS = 8  # blocks of a cluster that split K
# the direct kernel's shared memory (`csrc/hopper.cuh`, `csrc/int8_conv.cu`)
SMEM_MAX = 232448  # bytes one block may use
DIRECT_MAX_RING = 16  # stages of its B ring, at most
DIRECT_TAPS_PER_STAGE = 2  # taps of 64 bytes of K in one stage


def valid_cin_p(cin_p: int) -> bool:
    """The packed channel counts the kernels take: 16, 32, 64 or a multiple
    of 128, so that every K tile (64 or 128 bytes) holds whole taps or one
    slice of a tap."""
    return cin_p in (16, 32, 64) or (cin_p > 0 and cin_p % 128 == 0)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm_takes(C: int, S: int) -> bool:
    """Whether the GEMM's TMA map takes the activation [B, C, S]: rows of
    16 bytes or more, whole in a box: a linear's [B, C] with C % 8 == 0, or
    S % 64 == 0 (64-cell boxes), or whole samples of 8, 16 or 32 cells."""
    if S == 1:
        return C % 8 == 0
    return S % 64 == 0 or S in (8, 16, 32)


def direct_fits(cin_p: int, k: int, bm: int, bn: int) -> bool:
    """Whether the direct kernel's shared memory holds a bm x bn tile of a
    k^3 conv on an 8 x 8 grid: its two halo buffers (bm / 64 + k - 1 planes
    of (8 + k - 1)^2 cells, 32 or 64 channels), a B ring of at least two
    stages, and the epilogue's [bn][bm + 8] bfloat16 tile staged in that
    ring (`direct_geometry` in `csrc/int8_conv.cu`, which checks it again)."""
    n_cells = (bm // 64 + k - 1) * (8 + k - 1) ** 2
    halo = min(cin_p, 64) // 16 * ((n_cells + 6) // 8 * 8 + 1) * 16
    left = SMEM_MAX - 1024 - (2 * DIRECT_MAX_RING + 4) * 8 - 2 * halo
    stage = DIRECT_TAPS_PER_STAGE * bn * 64
    stages = min(left // stage, DIRECT_MAX_RING)
    return stages >= 2 and stages * stage >= bn * (bm + 8) * 2


def kernel_for(C: int, D: int, H: int, W: int, cin_p: int, k: int, bm: int, bn: int) -> str:
    """The kernel of a conv of k^3 taps on a [B, C, D, H, W] activation
    (a linear: D = H = W = k = 1), (`bm`, `bn`) the conv kernels' tile:
    "gemm" for k = 1 where the GEMM takes the activation; "direct" for the
    8 x 8 grids (whole z-planes a tile, cin_p a multiple of 32) where its
    halo and ring fit (`direct_fits`); "gather" for the rest (k = 2 and 4
    on the 4^3 and 2^3 grids, a 3^3 grid's 1x1x1 conv, k = 7 at a wide
    tile)."""
    if k == 1 and gemm_takes(C, D * H * W):
        return "gemm"
    if (k > 1 and cin_p % 32 == 0 and H == 8 and W == 8 and D % (bm // 64) == 0
            and direct_fits(cin_p, k, bm, bn)):
        return "direct"
    return "gather"


def tile_shape(M: int, cout: int, sms: int) -> tuple[int, int]:
    """(BM, BN) of the conv kernels' output tile for M positions and cout
    channels on a card of `sms` SMs: the widest tile (128 x the smallest of
    32/64/128 that covers cout) while it gives at least one block per SM,
    else narrower, BM first, so that small M (a routed sub-batch) still
    spreads over the card."""
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


def gemm_plan(M: int, cout: int, cin_p: int, sms: int) -> tuple[int, int]:
    """(BN, splits) of the GEMM for M rows, cout outputs and cin_p channels
    on a card of `sms` SMs.  BN is the smallest of 32/64/128/256 that covers
    cout, so that each activation is quantized once per block; where the
    128 x BN tiles alone give fewer blocks than SMs, K is split over a
    cluster of 2, 4 or 8 blocks (at most one 64-channel stage each), and
    then BN is halved down to 64."""
    bn = next(b for b in (32, 64, 128, 256) if cout <= b or b == 256)
    stages = -(-cin_p // GEMM_BK)

    def blocks(bn, splits):
        return -(-M // GEMM_BM) * -(-cout // bn) * splits

    splits = 1
    while splits < MAX_SPLITS and 2 * splits <= stages and blocks(bn, splits) < sms:
        splits *= 2
    while bn > 64 and blocks(bn, splits) < sms:
        bn //= 2
    return bn, splits


def _bind(lib, name: str, n_ints: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
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
        raise ValueError(f"the int8 kernels run on CUDA tensors, got {x.device}")
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
    if B * D * H * W >= 2**31:
        raise ValueError(f"{B * D * H * W} positions: the kernels index them in 32 bits")
    require_tensor(x, "x", torch.bfloat16, (B, C, D, H, W), dev)
    require_tensor(w_q, "w_q", torch.int8, (cout, k ** 3, cin_p), dev)
    require_tensor(s_w, "s_w", torch.float32, (cout,), dev)
    require_tensor(b, "b", torch.float32, (cout,), dev)
    require_tensor(x_amax, "x_amax", torch.float32, (), dev)
    for name, t in (("x", x), ("w_q", w_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((B, cout, D, H, W), dtype=torch.bfloat16, device=dev)
    # zeroed by the launcher, on the stream
    amax = torch.empty((), dtype=torch.float32, device=dev) if want_amax else None
    if B == 0:
        return out, None if amax is None else amax.zero_()
    M, sms = B * D * H * W, sm_count(dev.index)
    bm, bn = tile_shape(M, cout, sms)
    which = kernel_for(C, D, H, W, cin_p, k, bm, bn)
    head = (x.data_ptr(), w_q.data_ptr(), x_amax.data_ptr(), s_w.data_ptr(), b.data_ptr(),
            out.data_ptr(), 0 if amax is None else amax.data_ptr(), int(bool(relu)))
    if which == "gemm":
        bn, splits = gemm_plan(M, cout, cin_p, sms)
        lib, args = GEMM, head + (B, C, D * H * W, cin_p, cout, bn, splits)
        fn = _bind(lib.lib(), "int8_gemm_launch", 8)
    else:
        lib = KERNEL
        args = head + (B, C, D, H, W, cin_p, cout, k, (k - 1) // 2, bm, bn,
                       int(which == "direct"))
        fn = _bind(lib.lib(), "int8_conv3d_launch", 13)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        code = fn(*args, stream)
    lib.check(code)
    (name,) = lib.launches
    lib.launches[name] += 1
    return out, amax
