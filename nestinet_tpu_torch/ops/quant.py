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

Layouts.  The quantized activation is written channels-last, [B, D, H, W,
cin_p], and the weights [cout, k^3, cin_p], with the channels zero-padded
to cin_p, a multiple of 16: one reduction index (tap, channel) then runs
along contiguous bytes, every 16-byte load stays inside one tap, and the
odd widths of the flagship (cin 20, 42, 60, 126) need no tail code in the
kernel.  Zero channels add nothing to the sum.  The output is bfloat16
NCDHW, the layout of the blocks around it.

`int8_conv3d` runs the hand-written CUDA kernel (`csrc/int8_conv.cu`) on a
CUDA tensor and its plain version, `int8_conv3d_reference`, on a CPU
tensor; that device check is the only place that chooses between the two.
The plain version is exact: an integer-valued float64 conv (every partial
sum is an integer below 2^53), then the same float32 epilogue in the same
order, so the kernel can be held to it bit for bit.

The switch is PyTorch's: `quantize_(model)` replaces each conv's and
linear's float kernel by its int8 kernel and scales, and a module runs the
int8 path from then on (JAX switches with a trace-time context instead).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import int8_cuda

CIN_ALIGN = 16


def padded_channels(cin: int) -> int:
    """The channel count of the packed int8 layouts: cin rounded up to a
    multiple of 16."""
    return -(-cin // CIN_ALIGN) * CIN_ALIGN


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
    from a forwarded bound, or from x's own max|x|."""
    amax = x.abs().amax() if x_amax is None else x_amax
    return torch.clamp(amax.to(torch.float32), min=1e-12) / 127.0


def quantize_activation(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """x NCDHW [B, C, D, H, W] or [B, C] -> int8 [B, D, H, W, C_p] or
    [B, C_p]: clip(round(x / s_x), -127, 127), channels last, zero-padded
    to a multiple of 16."""
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


def int8_conv3d(x_q, w_q, s_w, s_x, b, kernel: int) -> torch.Tensor:
    """The int8 MAC and its epilogue: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor (shapes as int8_conv3d_reference)."""
    if x_q.device.type == "cpu":
        return int8_conv3d_reference(x_q, w_q, s_w, s_x, b, kernel)
    return int8_cuda.int8_conv3d_cuda(x_q, w_q, s_w, s_x, b, kernel)


def conv3d_int8(x, w_q, s_w, b, kernel: int, x_amax=None) -> torch.Tensor:
    """Quantized drop-in for the SAME conv plus bias (JAX `conv_nd_int8`):
    x bfloat16 NCDHW -> bfloat16 NCDHW."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8 serving computes in bfloat16, got {x.dtype}")
    s_x = activation_scale(x, x_amax)
    return int8_conv3d(quantize_activation(x, s_x), w_q, s_w, s_x, b, kernel)


def linear_int8(x, w_q, s_w, b, x_amax=None) -> torch.Tensor:
    """Quantized drop-in for x @ w + b (JAX `linear_int8`): x bfloat16
    [B, cin] -> bfloat16 [B, cout], through the conv with D = H = W = 1 and
    a 1^3 kernel."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8 serving computes in bfloat16, got {x.dtype}")
    s_x = activation_scale(x, x_amax)
    x_q = quantize_activation(x, s_x)
    out = int8_conv3d(x_q.view(x_q.shape[0], 1, 1, 1, -1), w_q, s_w, s_x, b, 1)
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
