"""int8 serving: quantized conv3d and linear (inference only).

Counterpart of `nestinet_tpu/ops/quant.py`, with the same scheme:
  * weights: symmetric per-output-channel int8, quantized once at load on
    the host, bit for bit as `quantize_params_np` (`:175-227`):
    amax = max|w| over every axis but cout, scale = max(amax, 1e-12) / 127,
    w_q = clip(round(w / scale), -127, 127);
  * activations: symmetric per-tensor dynamic int8 (`:67-72`, `:106-112`):
    s_x = max(amax, 1e-12) / 127 from the input's max|x| or from a bound
    its producer forwarded (`ops/nn.py::ActQ`), x_q = clip(round(x / s_x),
    -127, 127), a division and never a multiply by the reciprocal;
  * the MAC: int8 x int8 -> int32, then the epilogue
    float(acc) * (s_w * s_x) + b in float32, rounded to bfloat16.

Layouts.  The weights are packed [cout, k^3, cin_p], with the channels
zero-padded to cin_p: 16, 32 or 64 up to 64 channels, else a multiple of
128 (cin 20 -> 32, 42 and 60 -> 64, 126 -> 128).  One reduction index
(tap, channel) then runs along contiguous bytes, and every 128-byte K tile
of the kernel holds whole taps or one 128-channel slice of a tap.  Zero
channels add nothing to the sum.  Activations stay bfloat16 NCDHW, the
layout of the blocks around the kernel, in and out.

`int8_conv3d_fused` runs a hand-written CUDA kernel on a CUDA tensor: the
int8 GEMM (`csrc/int8_gemm.cu`) at k = 1, the implicit-GEMM convs
(`csrc/int8_conv.cu`) above (`kernels/int8_cuda.py::kernel_for`).  Both
quantize the bfloat16 activation as they load it, so the int8 activation
never exists in device memory, and can apply ReLU and return max|out| (one
launch for conv + ReLU + bound where BatchNorm is folded, as JAX fuses
it).  On a CPU tensor it runs the plain version,
`int8_conv3d_fused_reference`: `activation_scale`, `quantize_activation`
and `int8_conv3d_reference` (+ ReLU + amax), composed; that device check is
the only place that chooses between the two.  The plain version is exact:
an integer-valued float64 conv (every partial sum is an integer below
2^53), then the same float32 epilogue in the same order, so the kernel can
be held to it bit for bit.

The switch is PyTorch's: `quantize_(model)` replaces each conv's and
linear's float kernel by its int8 kernel and scales, and a module runs the
int8 path from then on (JAX switches with a trace-time context instead).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import int8_cuda

K_TILE = 128  # bytes of K per tile of the CUDA kernel


def padded_channels(cin: int) -> int:
    """The channel count of the packed int8 layouts: 16, 32 or 64 for up to
    64 channels, else cin rounded up to a multiple of 128."""
    for c in (16, 32, 64):
        if cin <= c:
            return c
    return -(-cin // K_TILE) * K_TILE


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 kernel, OIDHW or [out, in] -> (w_q int8 [cout, k^3, cin_p],
    scale float32 [cout]) on w's device.  NumPy float32 on the host, as
    `quantize_params_np` computes it."""
    a = w.detach().cpu().numpy().astype(np.float32)
    amax = np.max(np.abs(a), axis=tuple(range(1, a.ndim)), keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    cout, cin = q.shape[:2]
    q = q.reshape(cout, cin, -1).transpose(0, 2, 1)  # [cout, taps, cin]
    packed = np.zeros((cout, q.shape[1], padded_channels(cin)), np.int8)
    packed[..., :cin] = q
    return (torch.from_numpy(packed).to(w.device),
            torch.from_numpy(scale.reshape(cout).astype(np.float32)).to(w.device))


def activation_scale(x: torch.Tensor, x_amax=None) -> torch.Tensor:
    """The per-tensor scale, a float32 0-d tensor: max(amax, 1e-12) / 127
    from a forwarded bound, or from x's own max|x|.  Divided by a 0-d
    tensor, not a Python float: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can differ from JAX's division in
    the last bit."""
    amax = torch.clamp((x.abs().amax() if x_amax is None else x_amax).to(torch.float32),
                       min=1e-12)
    return amax / torch.full((), 127.0, dtype=torch.float32, device=amax.device)


def quantize_activation(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """x NCDHW [B, C, D, H, W] or [B, C] -> int8 [B, D, H, W, C_p] or
    [B, C_p]: clip(round(x / s_x), -127, 127), channels last, zero-padded
    to `padded_channels(C)` (the plain version's layout)."""
    q = torch.clamp(torch.round(x.to(torch.float32) / s_x), -127, 127).to(torch.int8)
    if q.dim() == 5:
        q = q.permute(0, 2, 3, 4, 1)
    cin = q.shape[-1]
    out = torch.zeros(q.shape[:-1] + (padded_channels(cin),), dtype=torch.int8,
                      device=x.device)
    out[..., :cin] = q
    return out


def _epilogue(acc: torch.Tensor, s_w, s_x, b) -> torch.Tensor:
    """float(acc) * (s_w * s_x) + b in float32, one op at a time, then
    bfloat16; acc [B, cout, ...] holds exact integers."""
    shape = (1, -1) + (1,) * (acc.dim() - 2)
    scale = (s_w * s_x).view(shape)
    return (acc.to(torch.float32) * scale + b.view(shape)).to(torch.bfloat16)


def int8_conv3d_reference(x_q, w_q, s_w, s_x, b, kernel: int) -> torch.Tensor:
    """The plain int8 SAME conv: x_q [B, D, H, W, cin_p] int8, w_q [cout,
    k^3, cin_p] int8, s_w [cout], s_x [], b [cout] float32 -> bfloat16
    [B, cout, D, H, W]."""
    from .nn import _pad_same

    cout, cin_p = w_q.shape[0], w_q.shape[-1]
    x = x_q.permute(0, 4, 1, 2, 3).to(torch.float64)
    w = w_q.reshape(cout, kernel, kernel, kernel, cin_p).permute(0, 4, 1, 2, 3)
    acc = F.conv3d(_pad_same(x, kernel, 1), w.to(torch.float64))
    return _epilogue(acc, s_w, s_x, b)


def int8_conv3d_fused_reference(x, w_q, s_w, b, kernel: int, x_amax=None, *,
                                relu: bool = False, want_amax: bool = False):
    """The plain version of the fused kernel: x bfloat16 [B, C, D, H, W] ->
    (bfloat16 [B, cout, D, H, W], max|out| float32 [] or None): the scale
    from `x_amax` (or x's own max|x|), the quantize pass, the exact int8
    conv and its epilogue, then ReLU if asked."""
    s_x = activation_scale(x, x_amax)
    y = int8_conv3d_reference(quantize_activation(x, s_x), w_q, s_w, s_x, b, kernel)
    if relu:
        y = F.relu(y)
    return y, (y.abs().amax().to(torch.float32) if want_amax else None)


def int8_conv3d_fused(x, w_q, s_w, b, kernel: int, x_amax=None, *, relu: bool = False,
                      want_amax: bool = False):
    """Quantize, int8 MAC, epilogue (+ ReLU, + max|out|): the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor (shapes and outputs as
    `int8_conv3d_fused_reference`).  Without a forwarded bound the scale
    comes from max|x|, reduced here first."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8 serving computes in bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return int8_conv3d_fused_reference(x, w_q, s_w, b, kernel, x_amax, relu=relu,
                                           want_amax=want_amax)
    amax = x.abs().amax() if x_amax is None else x_amax
    return int8_cuda.int8_conv3d_cuda(x.contiguous(), w_q, s_w, b, kernel,
                                      amax.to(torch.float32), relu=relu,
                                      want_amax=want_amax)


def conv3d_int8(x, w_q, s_w, b, kernel: int, x_amax=None) -> torch.Tensor:
    """Quantized drop-in for the SAME conv plus bias (JAX `conv_nd_int8`):
    x bfloat16 NCDHW -> bfloat16 NCDHW."""
    return int8_conv3d_fused(x, w_q, s_w, b, kernel, x_amax)[0]


def linear_int8(x, w_q, s_w, b, x_amax=None, *, relu: bool = False) -> torch.Tensor:
    """Quantized drop-in for x @ w + b (JAX `linear_int8`), + ReLU if asked:
    x bfloat16 [B, cin] -> bfloat16 [B, cout], as the k = 1 conv with
    D = H = W = 1 (the int8 GEMM on the card)."""
    out, _ = int8_conv3d_fused(x.reshape(x.shape[0], -1, 1, 1, 1), w_q, s_w, b, 1, x_amax,
                               relu=relu)
    return out.view(x.shape[0], -1)


def quantize_(model: torch.nn.Module) -> torch.nn.Module:
    """Quantize every conv and linear kernel of `model` in place, once
    (JAX does it at load, `infer/predict.py:215-222`); raises if a kernel
    is already quantized.  Fold BatchNorm first (`ops/fold.py`)."""
    from .nn import _Conv3D, _Linear

    for name, m in model.named_modules():
        if isinstance(m, (_Conv3D, _Linear)):
            if m.quantized:
                raise ValueError(f"'{name}' is already quantized")
            m.quantize_()
    return model
