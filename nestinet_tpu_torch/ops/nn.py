"""Neural-net building blocks for the 3D-Inception CNNs, eval path.

Counterpart of `nestinet_tpu/ops/nn.py`.  Tensors are NCDHW inside the
blocks; parameters keep the haiku names (`w`, `b`, `gamma`, `beta`) and the
BatchNorm state keeps its names (`ema_mean`, `ema_var`, `bias`) as buffers,
so `convert.py` maps a haiku tree onto a state dict by path.  Conv kernels
are stored OIDHW and linear weights [out, in].

Padding follows TensorFlow's SAME rule: the total pad is
max((ceil(n/s) - 1) * s + k - n, 0) per axis, with the odd cell at the end
(kernels 2 and 4 of the flagship backbones pad asymmetrically).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """Pad the three spatial axes of an NCDHW tensor for a SAME window."""
    pads = []
    for size in reversed(x.shape[2:]):  # F.pad lists the last axis first
        pads.extend(_same_pads(size, kernel, stride))
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


class BatchNormEMA(nn.Module):
    """Eval-mode BatchNorm over a zero-debiased EMA of batch moments:
    mean = ema_mean / max(1 - bias, 1e-12), likewise the variance, and
    (x - mean) * gamma * rsqrt(var + 1e-3) + beta."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("ema_mean", torch.zeros(channels))
        self.register_buffer("ema_var", torch.zeros(channels))
        self.register_buffer("bias", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        denom = torch.clamp(1.0 - self.bias, min=1e-12)
        mean = self.ema_mean / denom
        var = self.ema_var / denom
        inv = self.gamma * torch.rsqrt(var + BN_EPS)
        shape = (1, -1) + (1,) * (x.dim() - 2)  # channels on axis 1
        return (x - mean.view(shape)) * inv.view(shape) + self.beta.view(shape)


class _Conv3D(nn.Module):
    """Stride-1 3D conv with bias, SAME padding; `w` is OIDHW."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.w = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel % 2 == 1:
            # symmetric SAME pad: let the conv do it
            return F.conv3d(x, self.w, self.b, padding=self.kernel // 2)
        return F.conv3d(_pad_same(x, self.kernel, 1), self.w, self.b)


class _Linear(nn.Module):
    """Linear with bias; `w` is [out, in]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w, self.b)


class ConvBN3D(nn.Module):
    """Stride-1 3D conv + bias + EMA BatchNorm + ReLU, NCDHW, SAME padding
    (the only form the backbones use)."""

    def __init__(self, cin: int, channels: int, kernel: int):
        super().__init__()
        self.conv = _Conv3D(cin, channels, kernel)
        self.bn = BatchNormEMA(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class DenseBN(nn.Module):
    """Linear + bias (+ EMA BatchNorm) (+ ReLU)."""

    def __init__(self, cin: int, units: int, *, bn: bool = False, relu: bool = True):
        super().__init__()
        self.linear = _Linear(cin, units)
        self.bn = BatchNormEMA(units) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


def max_pool3d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """3D max pool, SAME padding with a -inf pad, NCDHW."""
    x = _pad_same(x, kernel, stride, value=float("-inf"))
    return F.max_pool3d(x, kernel, stride)


def avg_pool3d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """3D average pool, SAME padding; the divisor counts only the valid
    (unpadded) cells of each window, as TensorFlow does.  torch's
    `count_include_pad=False` covers symmetric pads only, so the pad and the
    divisor are written out."""
    sums = F.avg_pool3d(_pad_same(x, kernel, stride), kernel, stride,
                        divisor_override=1)
    counts = None
    for axis, size in enumerate(x.shape[2:]):
        ones = torch.ones((size,), dtype=x.dtype, device=x.device)
        c = _window_counts(ones, kernel, stride)
        shape = [1, 1, 1, 1, 1]
        shape[2 + axis] = c.shape[-1]
        c = c.reshape(shape)
        counts = c if counts is None else counts * c
    return sums / counts


def _window_counts(ones: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Number of valid cells in each SAME window along one axis."""
    padded = F.pad(ones, _same_pads(ones.shape[0], kernel, stride))
    return padded.unfold(0, kernel, stride).sum(-1)


class Inception3D(nn.Module):
    """The 3D inception block: a 1x1x1 conv of n, two k1^3 / k2^3 convs of
    n/2 on its output, and avgpool(k1, stride 1) -> 1x1x1 conv of n; the
    four are concatenated on channels (3n outputs).  The pool branch runs
    in the reference order relu(BN(conv(avgpool(x)))) for every width."""

    def __init__(self, cin: int, n_filters: int, kernel_sizes=(3, 5)):
        super().__init__()
        n = int(n_filters)
        self.k1, self.k2 = kernel_sizes
        self.conv1 = ConvBN3D(cin, n, 1)
        self.conv2 = ConvBN3D(n, n // 2, self.k1)
        self.conv3 = ConvBN3D(n, n // 2, self.k2)
        self.conv4 = ConvBN3D(cin, n, 1)
        self.out_channels = n + 2 * (n // 2) + n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        one = self.conv1(x)
        b1 = self.conv2(one)
        b2 = self.conv3(one)
        ap = self.conv4(avg_pool3d(x, self.k1, 1))
        return torch.cat([one, b1, b2, ap], dim=1)


class Backbone(nn.Module):
    """A backbone given as a list of layer specs, then a flatten in NDHWC
    order (so the first FC layer's weights convert by a plain transpose).

    Spec entries: ("incep", n_filters, (k1, k2)) and ("maxpool", k, s).
    Inception blocks are named `incep{i}` by their index in the spec, as in
    the reference.
    """

    def __init__(self, spec, cin: int, resolution: int):
        super().__init__()
        self.spec = [tuple(e) for e in spec]
        c, r = cin, resolution
        for i, entry in enumerate(self.spec):
            if entry[0] == "incep":
                block = Inception3D(c, entry[1], entry[2])
                self.add_module(f"incep{i}", block)
                c = block.out_channels
            elif entry[0] == "maxpool":
                r = -(-r // entry[2])
            else:
                raise ValueError(f"unknown backbone entry: {entry}")
        self.out_features = c * r ** 3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, entry in enumerate(self.spec):
            if entry[0] == "incep":
                x = getattr(self, f"incep{i}")(x)
            else:
                x = max_pool3d(x, entry[1], entry[2])
        return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
