"""Neural-net building blocks for the 3D-Inception CNNs.

Counterpart of `nestinet_tpu/ops/nn.py`.  Every block takes `training`
and the scheduled BatchNorm `momentum` per call, as JAX's take
`is_training` and `bn_momentum`: in training BatchNorm normalizes with the
batch moments and folds them into its EMA state.  Tensors are NCDHW inside
the blocks; parameters keep the haiku names (`w`, `b`, `gamma`, `beta`) and the
BatchNorm state keeps its names (`ema_mean`, `ema_var`, `bias`) as buffers,
so `convert.py` maps a haiku tree onto a state dict by path.  Conv kernels
are stored OIDHW and linear weights [out, in].

Compute dtype: parameters stay float32 master copies and every op casts
them to its input's dtype (JAX `ops/nn.py:89-115,150-157,182`), so one
checkpoint serves in float32 or bfloat16.  The bias is added after the
conv/matmul has been rounded, as a separate op in the input's dtype.

int8 (`ops/quant.py`): a conv or linear whose weights were quantized at
load (`quantize_()`) runs the int8 kernel, which quantizes its bfloat16
input as it loads it.  Its input's activation scale comes from an `ActQ`
bound when the producer forwarded one: each quantized ConvBN3D emits
max|out| of its BN(+ReLU) output, pools keep their input's bound, the
Inception concat takes the max over its branches and the backbone flatten
hands the bound to FC1 (JAX `ops/nn.py:39-64`).  Without a bound (the first
conv of a CNN, FC2 onwards) the op reduces its own input.  Where BatchNorm
is folded (an identity), ReLU and the bound ride the kernel's epilogue: one
launch per conv.

Padding follows TensorFlow's SAME rule: the total pad is
max((ceil(n/s) - 1) * s + k - n, 0) per axis, with the odd cell at the end
(kernels 2 and 4 of the flagship backbones pad asymmetrically).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import quant

BN_EPS = 1e-3


class ActQ(NamedTuple):
    """An activation with a scalar float32 upper bound on |x| (int8
    serving only; JAX `ops/nn.py::ActQ`)."""

    x: torch.Tensor
    amax: torch.Tensor


def unwrap(x):
    """(tensor, amax or None) from a plain tensor or an ActQ."""
    if isinstance(x, ActQ):
        return x.x, x.amax
    return x, None


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
    """BatchNorm over a zero-debiased EMA of batch moments (JAX
    `ops/nn.py:67-115`).

    Training: float32 moments of the batch over every axis but channels,
    the population variance (`jnp.var`), and the EMA state updated with
    the momentum passed per call, `ema = m*ema + (1-m)*moment`, `bias =
    m*bias`, outside autograd.  Eval: the debiased EMA moments in float32,
    cast to x.dtype.  Both then take JAX's casts: inv = gamma * rsqrt(var +
    1e-3) and (x - mean) * inv + beta in x.dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("ema_mean", torch.zeros(channels))
        self.register_buffer("ema_var", torch.zeros(channels))
        self.register_buffer("bias", torch.ones(()))

    def forward(self, x: torch.Tensor, training: bool = False, momentum=None) -> torch.Tensor:
        if training:
            xf = x.float()
            axes = [0] + list(range(2, x.dim()))  # every axis but channels
            mean = xf.mean(dim=axes)
            var = xf.var(dim=axes, unbiased=False)
            with torch.no_grad():
                m = torch.as_tensor(momentum, dtype=torch.float32, device=x.device)
                self.ema_mean.copy_(m * self.ema_mean + (1.0 - m) * mean)
                self.ema_var.copy_(m * self.ema_var + (1.0 - m) * var)
                self.bias.copy_(m * self.bias)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        else:
            denom = torch.clamp(1.0 - self.bias, min=1e-12)
            mean = (self.ema_mean / denom).to(x.dtype)
            var = (self.ema_var / denom).to(x.dtype)
        # eps is rounded to x.dtype first, as JAX's weakly typed scalar is;
        # rsqrt runs in float32 and rounds once (torch's bfloat16 rsqrt
        # rounds twice on small tensors)
        var = var + torch.tensor(BN_EPS, dtype=x.dtype)
        inv = self.gamma.to(x.dtype) * torch.rsqrt(var.float()).to(x.dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)  # channels on axis 1
        return (x - mean.view(shape)) * inv.view(shape) + self.beta.to(x.dtype).view(shape)


def _batch_norm(bn: nn.Module, x: torch.Tensor, training: bool, momentum):
    """A BatchNormEMA, or the nn.Identity that folding left in its place
    (serving only, so never in training)."""
    return bn(x, True, momentum) if training else bn(x)


class _Conv3D(nn.Module):
    """Stride-1 3D conv with bias, SAME padding; `w` is OIDHW, zero until
    the model initializes it (`models/base.py::init_params`).  After
    `quantize_()` the float kernel is gone and `w_q` [cout, k^3, cin_p]
    int8 with `w_scale` [cout] take its place."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.w = nn.Parameter(torch.zeros(cout, cin, kernel, kernel, kernel))
        self.b = nn.Parameter(torch.zeros(cout))
        self.register_buffer("w_q", None)
        self.register_buffer("w_scale", None)

    @property
    def quantized(self) -> bool:
        return self.w_q is not None

    @torch.no_grad()
    def quantize_(self) -> None:
        self.w_q, self.w_scale = quant.quantize_weight(self.w)
        self.w = None

    def forward(self, x: torch.Tensor, x_amax=None) -> torch.Tensor:
        if self.quantized:
            return quant.conv3d_int8(x, self.w_q, self.w_scale, self.b, self.kernel, x_amax)
        w = self.w.to(x.dtype)
        if self.kernel % 2 == 1:
            # symmetric SAME pad: let the conv do it
            out = F.conv3d(x, w, padding=self.kernel // 2)
        else:
            out = F.conv3d(_pad_same(x, self.kernel, 1), w)
        return out + self.b.to(x.dtype).view(1, -1, 1, 1, 1)


class _Linear(nn.Module):
    """Linear with bias; `w` is [out, in].  `quantize_()` as in _Conv3D,
    with `w_q` [cout, 1, cin_p]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin))
        self.b = nn.Parameter(torch.zeros(cout))
        self.register_buffer("w_q", None)
        self.register_buffer("w_scale", None)

    quantized = _Conv3D.quantized
    quantize_ = _Conv3D.quantize_

    def forward(self, x: torch.Tensor, x_amax=None) -> torch.Tensor:
        if self.quantized:
            return quant.linear_int8(x, self.w_q, self.w_scale, self.b, x_amax)
        return F.linear(x, self.w.to(x.dtype)) + self.b.to(x.dtype)


class ConvBN3D(nn.Module):
    """Stride-1 3D conv + bias + EMA BatchNorm (+ ReLU), NCDHW, SAME padding
    (the only form the backbones use).  Quantized, it returns an ActQ whose
    bound is max|out| of what it returns."""

    def __init__(self, cin: int, channels: int, kernel: int):
        super().__init__()
        self.conv = _Conv3D(cin, channels, kernel)
        self.bn = BatchNormEMA(channels)

    def forward(self, x, relu: bool = True, training: bool = False, momentum=None):
        x, x_amax = unwrap(x)
        if self.conv.quantized and isinstance(self.bn, nn.Identity):
            # BN folded: conv + ReLU + max|out| in one launch
            c = self.conv
            return ActQ(*quant.int8_conv3d_fused(x, c.w_q, c.w_scale, c.b, c.kernel, x_amax,
                                                 relu=relu, want_amax=True))
        y = _batch_norm(self.bn, self.conv(x, x_amax), training, momentum)
        if relu:
            y = F.relu(y)
        if self.conv.quantized:
            return ActQ(y, y.abs().amax().to(torch.float32))
        return y


class DenseBN(nn.Module):
    """Linear + bias (+ EMA BatchNorm) (+ ReLU); returns a plain tensor."""

    def __init__(self, cin: int, units: int, *, bn: bool = False, relu: bool = True):
        super().__init__()
        self.linear = _Linear(cin, units)
        self.bn = BatchNormEMA(units) if bn else None
        self.relu = relu

    def forward(self, x, training: bool = False, momentum=None) -> torch.Tensor:
        x, x_amax = unwrap(x)
        if self.linear.quantized and not isinstance(self.bn, BatchNormEMA):
            # no BN, or BN folded: the ReLU rides the int8 kernel's epilogue
            lin = self.linear
            return quant.linear_int8(x, lin.w_q, lin.w_scale, lin.b, x_amax, relu=self.relu)
        x = self.linear(x, x_amax)
        if self.bn is not None:
            x = _batch_norm(self.bn, x, training, momentum)
        return F.relu(x) if self.relu else x


def max_pool3d(x, kernel: int, stride: int):
    """3D max pool, SAME padding with a -inf pad, NCDHW; an ActQ keeps its
    bound."""
    x, x_amax = unwrap(x)
    out = F.max_pool3d(_pad_same(x, kernel, stride, value=float("-inf")), kernel, stride)
    return out if x_amax is None else ActQ(out, x_amax)


def avg_pool3d(x, kernel: int, stride: int, *, separable: bool = True):
    """3D average pool, SAME padding; the divisor counts only the valid
    (unpadded) cells of each window, as TensorFlow does, and is the outer
    product of the per-axis valid counts.  An ActQ keeps its bound.

    Separable (serving, JAX `ops/nn.py:394-414`): one window sum per spatial
    axis, each summed one cell at a time in x.dtype.  `separable=False`
    (training, JAX `:383-393`): one k^3 window sum, which keeps no
    per-axis intermediates for the backward pass, taken in float32."""
    x, x_amax = unwrap(x)
    sums = x
    counts = torch.ones((), dtype=x.dtype, device=x.device)
    for axis in (2, 3, 4):
        size = x.shape[axis]
        lo, hi = _same_pads(size, kernel, stride)
        if separable:
            pads = [0, 0] * 3
            pads[2 * (4 - axis)] = lo  # F.pad lists the last axis first
            pads[2 * (4 - axis) + 1] = hi
            windows = F.pad(sums, pads).unfold(axis, kernel, stride)
            sums = windows[..., 0]
            for j in range(1, kernel):
                sums = sums + windows[..., j]
        ones = torch.ones((size,), dtype=x.dtype, device=x.device)
        c = F.pad(ones, (lo, hi)).unfold(0, kernel, stride).sum(-1)
        shape = [1, 1, 1, 1, 1]
        shape[axis] = c.shape[0]
        counts = counts * c.reshape(shape)
    if not separable:
        # the window sums in float32, rounded once to x.dtype (what CUDA's
        # bfloat16 kernel does; the CPU has none)
        sums = F.avg_pool3d(_pad_same(x, kernel, stride).float(), kernel, stride,
                            divisor_override=1).to(x.dtype)
    out = sums / counts
    return out if x_amax is None else ActQ(out, x_amax)


class Inception3D(nn.Module):
    """The 3D inception block: a 1x1x1 conv of n, two k1^3 / k2^3 convs of
    n/2 on its output, and a pool branch of a stride-1 k1^3 average pool
    and a 1x1x1 conv of n; the four are concatenated on channels (3n
    outputs).

    The pool branch follows JAX's order (`ops/nn.py:425-459`).  In training
    and when cin <= n: relu(BN(conv(avgpool(x)))), the pool non-separable
    in training.  At inference with cin > n the conv and BN run first on x,
    without ReLU, then the pool, then the ReLU (the same function up to
    float reassociation, on n instead of cin channels).  Under int8 that
    branch carries the bound of its pre-ReLU BN output."""

    def __init__(self, cin: int, n_filters: int, kernel_sizes=(3, 5)):
        super().__init__()
        n = int(n_filters)
        self.cin, self.n = cin, n
        self.k1, self.k2 = kernel_sizes
        self.conv1 = ConvBN3D(cin, n, 1)
        self.conv2 = ConvBN3D(n, n // 2, self.k1)
        self.conv3 = ConvBN3D(n, n // 2, self.k2)
        self.conv4 = ConvBN3D(cin, n, 1)
        self.out_channels = n + 2 * (n // 2) + n

    def forward(self, x, training: bool = False, momentum=None):
        bn = dict(training=training, momentum=momentum)
        one = self.conv1(x, **bn)
        b1 = self.conv2(one, **bn)
        b2 = self.conv3(one, **bn)
        if training or self.cin <= self.n:
            ap = self.conv4(avg_pool3d(x, self.k1, 1, separable=not training), **bn)
        else:
            ap, ap_amax = unwrap(self.conv4(x, relu=False))
            ap = F.relu(avg_pool3d(ap, self.k1, 1))
            ap = ap if ap_amax is None else ActQ(ap, ap_amax)
        parts = [one, b1, b2, ap]
        if all(isinstance(p, ActQ) for p in parts):
            return ActQ(torch.cat([p.x for p in parts], dim=1),
                        torch.stack([p.amax for p in parts]).amax())
        return torch.cat([unwrap(p)[0] for p in parts], dim=1)


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

    def forward(self, x, training: bool = False, momentum=None):
        for i, entry in enumerate(self.spec):
            if entry[0] == "incep":
                x = getattr(self, f"incep{i}")(x, training, momentum)
            else:
                x = max_pool3d(x, entry[1], entry[2])
        x, x_amax = unwrap(x)
        x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        return x if x_amax is None else ActQ(x, x_amax)


class Dropout:
    """Where the dropout layers of one forward pass take their keep masks
    (JAX `ops/nn.py:496-499`, haiku's `hk.dropout`): each mask is
    U[0, 1) < 1 - rate in float32, drawn from `generator` (None: torch's
    default generator of the input's device), or, when `masks` is given,
    the next of those bool tensors in call order (a test replays JAX's
    masks this way)."""

    def __init__(self, generator: torch.Generator | None = None, masks=None):
        self.generator = generator
        self.masks = None if masks is None else list(masks)

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep_rate = 1.0 - rate
        if self.masks is not None:
            keep = self.masks.pop(0).to(device=x.device, dtype=torch.bool)
        else:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_rate
        # haiku's keep * x / keep_rate; the divisor is a 0-d tensor, as a
        # Python float becomes a multiply by its reciprocal on CUDA
        return keep * x / torch.tensor(keep_rate, dtype=x.dtype, device=x.device)


def dropout(x: torch.Tensor, rate: float, training: bool, source: Dropout | None = None):
    """Drop each element with probability `rate` and scale the rest by
    1 / (1 - rate) in training; the identity in eval or at rate 0."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if not training or rate == 0.0:
        return x
    return (source if source is not None else Dropout())(x, rate)


def l2_weight_penalty(module: nn.Module) -> torch.Tensor:
    """Sum of 0.5 * ||w||^2 over the conv and linear kernels in float32;
    biases and BatchNorm parameters are left out (JAX `ops/nn.py:502-514`,
    the reference's 'losses' collection, `tf_util.py:36-54`)."""
    terms = [0.5 * torch.sum(torch.square(p.float()))
             for name, p in module.named_parameters() if name.rsplit(".", 1)[-1] == "w"]
    return torch.stack(terms).sum()
