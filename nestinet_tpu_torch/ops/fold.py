"""Inference-time BatchNorm folding (serving only).

Counterpart of `nestinet_tpu/ops/fold.py` (`fold_bn_params_np:104-183`),
written against the torch module tree instead of the haiku trees.  At eval
every `BatchNormEMA` is a fixed per-channel affine on the output of the
conv or linear beside it (the `conv` / `linear` sibling inside `ConvBN3D`
and `DenseBN`), so it folds exactly into that kernel:

    s  = gamma / sqrt(var + 1e-3)       (debiased EMA moments)
    w' = w * s                          (per output channel)
    b' = (b - mean) * s + beta

computed in float32 torch ops on the tensors' own device (the card, when
`infer/predict.py::load_run` serves there), one rounding an op in the
order JAX's NumPy code takes (the square root taken in float64 and
rounded once, which is float32's correctly rounded one), so the folded
kernels and biases are JAX's bit for bit.  Every constant is a float32
tensor on that device: CUDA divides by a Python scalar or a CPU 0-d
tensor as a multiply by its reciprocal (`ops/quant.py::activation_scale`).
The BN module is then replaced by an identity.  All or nothing: a BN
without a conv/linear sibling raises, and so does a kernel that is already
quantized (fold first, then quantize, as `load_run` does).
"""

from __future__ import annotations

import torch
from torch import nn

from .nn import BN_EPS, BatchNormEMA, _Conv3D, _Linear


def _debiased_moments(bn: BatchNormEMA) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchNormEMA's eval read: the zero-debiased EMA moments, float32."""
    one = torch.ones((), dtype=torch.float32, device=bn.bias.device)
    denom = torch.clamp(one - bn.bias.float(), min=1e-12)
    return bn.ema_mean.float() / denom, bn.ema_var.float() / denom


@torch.no_grad()
def fold_bn_(model: nn.Module, eps: float = BN_EPS) -> nn.Module:
    """Fold every eval BatchNorm of `model` into its sibling conv/linear
    kernel, in place; each BN becomes an identity."""
    for parent_name, parent in list(model.named_modules()):
        for name, child in list(parent.named_children()):
            if not isinstance(child, BatchNormEMA):
                continue
            path = f"{parent_name}.{name}" if parent_name else name
            target = getattr(parent, "conv", getattr(parent, "linear", None))
            if name != "bn" or not isinstance(target, (_Conv3D, _Linear)):
                raise ValueError(f"BN at '{path}' has no conv/linear sibling to fold into")
            if target.quantized:
                raise ValueError(f"the kernel beside '{path}' is already quantized: "
                                 "fold BN before int8")
            mean, var = _debiased_moments(child)
            eps_t = torch.full((), eps, dtype=torch.float32, device=var.device)
            # the float32 square root, correctly rounded as NumPy's: taken in
            # float64 and rounded once (PyTorch's CPU float32 sqrt of a long
            # vector may be off by an ulp)
            root = torch.sqrt((var + eps_t).double()).float()
            sc = child.gamma.float() / root  # [cout]
            w = target.w.float()
            w = w * sc.view((-1,) + (1,) * (w.dim() - 1))  # cout is axis 0
            b = (target.b.float() - mean) * sc + child.beta.float()
            target.w.copy_(w)
            target.b.copy_(b)
            setattr(parent, name, nn.Identity())
    return model
