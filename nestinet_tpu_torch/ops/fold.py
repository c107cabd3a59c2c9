"""Inference-time BatchNorm folding (serving only).

Counterpart of `nestinet_tpu/ops/fold.py` (`fold_bn_params_np:104-183`),
written against the torch module tree instead of the haiku trees.  At eval
every `BatchNormEMA` is a fixed per-channel affine on the output of the
conv or linear beside it (the `conv` / `linear` sibling inside `ConvBN3D`
and `DenseBN`), so it folds exactly into that kernel:

    s  = gamma / sqrt(var + 1e-3)       (debiased EMA moments)
    w' = w * s                          (per output channel)
    b' = (b - mean) * s + beta

computed in NumPy float32 on the host, as JAX computes it; the BN module is
then replaced by an identity.  All or nothing: a BN without a conv/linear
sibling raises, and so does a kernel that is already quantized (fold
first, then quantize, as `infer/predict.py::load_run` does).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .nn import BN_EPS, BatchNormEMA, _Conv3D, _Linear


def _debiased_moments(bn: BatchNormEMA) -> tuple[np.ndarray, np.ndarray]:
    """BatchNormEMA's eval read: the zero-debiased EMA moments, float32."""
    bias = bn.bias.detach().cpu().numpy().astype(np.float32)
    denom = np.maximum(1.0 - bias, 1e-12)
    mean = bn.ema_mean.detach().cpu().numpy().astype(np.float32) / denom
    var = bn.ema_var.detach().cpu().numpy().astype(np.float32) / denom
    return mean, var


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
            gamma = child.gamma.detach().cpu().numpy().astype(np.float32)
            beta = child.beta.detach().cpu().numpy().astype(np.float32)
            mean, var = _debiased_moments(child)
            sc = gamma / np.sqrt(var + eps)  # [cout]
            w = target.w.detach().cpu().numpy().astype(np.float32)
            b = target.b.detach().cpu().numpy().astype(np.float32)
            w = w * sc.reshape((-1,) + (1,) * (w.ndim - 1))  # cout is axis 0
            b = (b - mean) * sc + beta
            target.w.copy_(torch.from_numpy(w.astype(np.float32)))
            target.b.copy_(torch.from_numpy(b.astype(np.float32)))
            setattr(parent, name, nn.Identity())
    return model
