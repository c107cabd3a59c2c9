"""The plain reference of the benchmark's models, in float32 PyTorch.

Built from a configuration file of `portbench/configs/` alone: the layer
table there, the published order of every block, and weights in a flat
dict whose keys name each tensor by its place in the model
(`param_specs`).  It imports nothing of the program.

The blocks, in eval mode:
  * ConvBN: a stride-1 3-D conv with TensorFlow's SAME padding (the odd
    cell at the end), bias, BatchNorm over the debiased EMA moments
    (mean = ema_mean / (1 - bias), var = ema_var / (1 - bias), eps 1e-3),
    ReLU;
  * Inception(n, k1, k2): ConvBN(cin -> n, 1); ConvBN(n -> n/2, k1) and
    ConvBN(n -> n/2, k2) on the first's output; the pool branch, a stride-1
    k1^3 average pool over the valid cells, then ConvBN(cin -> n, 1); the
    four concatenated on channels;
  * maxpool(k, s) with SAME padding; the flatten in (D, H, W, C) order;
  * FC head: hidden Linear + BatchNorm + ReLU, then a last Linear (ReLU
    for the manager);
  * the mixture of experts: softmax(manager) in float32 over the experts;
    expert i reads its scales' 20-channel slices of the statistics grid.

`quant_bits` (the control only) folds every BatchNorm into its conv or
linear, then quantizes each kernel per output channel and each input per
tensor, symmetrically, at that many bits, as an integer path of that width
would.

`calibrate` (the benchmark's weights only, `weights.py`) sets each
BatchNorm's EMA moments, in layer order, to the moments of its own input
over the batch it is given, so that every layer passes on how patches
differ rather than a constant.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


def layer_table(cfg: dict, part: str, n_scales: int | None = None) -> list:
    """The backbone spec of `part` ("manager", "expert" or "net") with the
    expert's first width resolved for its scale count."""
    spec = []
    for entry in cfg[part]["backbone"]:
        if entry[0] == "incep" and isinstance(entry[1], str):
            num, _, den = entry[1].partition("//")
            assert den.strip() == "n_scales", entry
            entry = ["incep", int(num) // n_scales, entry[2]]
        spec.append(entry)
    return spec


def expert_scales(cfg: dict) -> list:
    return [sorted(cfg["expert_dict"][str(i)]) for i in range(cfg["n_experts"])]


def _conv_specs(prefix: str, cin: int, cout: int, k: int):
    yield f"{prefix}.conv.w", (cout, cin, k, k, k), "w"
    yield f"{prefix}.conv.b", (cout,), "b"
    yield from _bn_specs(f"{prefix}.bn", cout)


def _bn_specs(prefix: str, c: int):
    yield f"{prefix}.gamma", (c,), "gamma"
    yield f"{prefix}.beta", (c,), "beta"
    yield f"{prefix}.ema_mean", (c,), "ema_mean"
    yield f"{prefix}.ema_var", (c,), "ema_var"
    yield f"{prefix}.bias", (), "bn_bias"


def _net_specs(prefix: str, spec: list, cin: int, res: int, fc: list):
    c, r = cin, res
    for i, entry in enumerate(spec):
        if entry[0] == "maxpool":
            r = -(-r // entry[2])
            continue
        n, (k1, k2) = entry[1], entry[2]
        p = f"{prefix}.backbone.incep{i}"
        yield from _conv_specs(f"{p}.conv1", c, n, 1)
        yield from _conv_specs(f"{p}.conv2", n, n // 2, k1)
        yield from _conv_specs(f"{p}.conv3", n, n // 2, k2)
        yield from _conv_specs(f"{p}.conv4", c, n, 1)
        c = n + 2 * (n // 2) + n
    c = c * r ** 3
    for j, units in enumerate(fc):
        p = f"{prefix}.head.fc{j + 1}"
        yield f"{p}.linear.w", (units, c), "w"
        yield f"{p}.linear.b", (units,), "b"
        if j < len(fc) - 1:
            yield from _bn_specs(f"{p}.bn", units)
        c = units


def param_specs(cfg: dict) -> list:
    """[(key, shape, kind)] of every tensor of the model, in model order;
    kind is "w", "b", "gamma", "beta", "ema_mean", "ema_var" or "bn_bias"."""
    S, res = len(cfg["patch_radius"]), cfg["num_gaussians"]
    if cfg["model"] == "experts_n_est":
        out = list(_net_specs("manager", layer_table(cfg, "manager"), 20 * S, res,
                              cfg["manager"]["fc"]))
        for i, scales in enumerate(expert_scales(cfg)):
            s = len(scales)
            out += _net_specs(f"experts.{i}", layer_table(cfg, "expert", s), 20 * s, res,
                              cfg["expert"]["fc"])
        return out
    return list(_net_specs("net", layer_table(cfg, "net"), 20 * S, res, cfg["net"]["fc"]))


def n_parameters(cfg: dict) -> int:
    """Trainable values: kernels, biases, BatchNorm gamma and beta."""
    return sum(math.prod(shape) for _, shape, kind in param_specs(cfg)
               if kind in ("w", "b", "gamma", "beta"))


# ---------------------------------------------------------------- blocks


def _same(size: int, k: int, s: int) -> tuple:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad3(x, k: int, s: int, value: float = 0.0):
    pads = []
    for size in reversed(x.shape[2:]):
        pads.extend(_same(size, k, s))
    return F.pad(x, pads, value=value) if any(pads) else x


class Net:
    """One backbone + FC head over weights `W` under `prefix`."""

    def __init__(self, W: dict, prefix: str, spec: list, fc: list, final_activation,
                 quant_bits: int | None = None, calibrate: bool = False):
        self.W, self.prefix, self.spec = W, prefix, spec
        self.n_fc, self.final_relu = len(fc), final_activation == "relu"
        self.quant_bits = quant_bits
        self.calibrate = calibrate

    def _q(self, x):
        """Per-tensor symmetric fake quantization of an input (control)."""
        if self.quant_bits is None:
            return x
        top = 2 ** (self.quant_bits - 1) - 1
        s = torch.clamp(x.abs().amax(), min=1e-12) / top
        return torch.clamp(torch.round(x / s), -top, top) * s

    def _qw(self, w):
        if self.quant_bits is None:
            return w
        top = 2 ** (self.quant_bits - 1) - 1
        dims = tuple(range(1, w.dim()))
        s = torch.clamp(w.abs().amax(dim=dims, keepdim=True), min=1e-12) / top
        return torch.clamp(torch.round(w / s), -top, top) * s

    def _set_moments(self, p: str, y, dims: tuple):
        """EMA moments of BatchNorm `p` such that its debiased mean and
        variance are those of `y` over `dims`."""
        keep = 1.0 - self.W[f"{p}.bias"]
        var, mean = torch.var_mean(y, dim=dims, correction=0)
        self.W[f"{p}.ema_mean"] = mean * keep
        self.W[f"{p}.ema_var"] = var * keep

    def _bn_affine(self, p: str):
        W = self.W
        denom = torch.clamp(1.0 - W[f"{p}.bias"], min=1e-12)
        mean, var = W[f"{p}.ema_mean"] / denom, W[f"{p}.ema_var"] / denom
        inv = W[f"{p}.gamma"] * torch.rsqrt(var + BN_EPS)
        return inv, W[f"{p}.beta"] - mean * inv

    def conv_bn(self, x, p: str, k: int, relu: bool = True):
        w, b = self.W[f"{p}.conv.w"], self.W[f"{p}.conv.b"]
        shape = (1, -1, 1, 1, 1)
        if self.quant_bits is None:
            y = F.conv3d(_pad3(x, k, 1), w) + b.view(shape)
            if self.calibrate:
                self._set_moments(f"{p}.bn", y, (0, 2, 3, 4))
            inv, shift = self._bn_affine(f"{p}.bn")
            y = y * inv.view(shape) + shift.view(shape)
        else:  # BatchNorm folded into the kernel, then quantized
            inv, shift = self._bn_affine(f"{p}.bn")
            wf = self._qw(w * inv.view(-1, 1, 1, 1, 1))
            y = F.conv3d(_pad3(self._q(x), k, 1), wf) + (b * inv + shift).view(shape)
        return F.relu(y) if relu else y

    def dense(self, x, p: str, bn: bool, relu: bool):
        w, b = self.W[f"{p}.linear.w"], self.W[f"{p}.linear.b"]
        if bn and self.calibrate:
            self._set_moments(f"{p}.bn", F.linear(x, w) + b, (0,))
        if bn:
            inv, shift = self._bn_affine(f"{p}.bn")
            w, b = w * inv[:, None], b * inv + shift
        if self.quant_bits is not None:
            x, w = self._q(x), self._qw(w)
        y = F.linear(x, w) + b
        return F.relu(y) if relu else y

    @staticmethod
    def avg_pool(x, k: int):
        """Stride-1 SAME average over the valid cells of each window."""
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        sums = F.avg_pool3d(_pad3(x, k, 1), k, 1, divisor_override=1)
        counts = F.avg_pool3d(_pad3(ones, k, 1), k, 1, divisor_override=1)
        return sums / counts

    def inception(self, x, p: str, k1: int, k2: int):
        one = self.conv_bn(x, f"{p}.conv1", 1)
        b1 = self.conv_bn(one, f"{p}.conv2", k1)
        b2 = self.conv_bn(one, f"{p}.conv3", k2)
        ap = self.conv_bn(self.avg_pool(x, k1), f"{p}.conv4", 1)
        return torch.cat([one, b1, b2, ap], dim=1)

    def backbone(self, x):
        for i, entry in enumerate(self.spec):
            if entry[0] == "incep":
                x = self.inception(x, f"{self.prefix}.backbone.incep{i}", *entry[2])
            else:
                k, s = entry[1], entry[2]
                x = F.max_pool3d(_pad3(x, k, s, float("-inf")), k, s)
        return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)

    def head_hidden(self, h):
        """The FC head up to the last layer's input."""
        for j in range(self.n_fc - 1):
            h = self.dense(h, f"{self.prefix}.head.fc{j + 1}", bn=True, relu=True)
        return h

    def __call__(self, x):
        h = self.head_hidden(self.backbone(x))
        return self.dense(h, f"{self.prefix}.head.fc{self.n_fc}", bn=False,
                          relu=self.final_relu)


def manager(cfg: dict, W: dict, quant_bits=None, calibrate=False) -> Net:
    m = cfg["manager"]
    return Net(W, "manager", layer_table(cfg, "manager"), m["fc"], m["final_activation"],
               quant_bits, calibrate)


def expert(cfg: dict, W: dict, i: int, quant_bits=None, calibrate=False) -> Net:
    s = len(expert_scales(cfg)[i])
    e = cfg["expert"]
    return Net(W, f"experts.{i}", layer_table(cfg, "expert", s), e["fc"],
               e["final_activation"], quant_bits, calibrate)


def ms_net(cfg: dict, W: dict, quant_bits=None, calibrate=False) -> Net:
    n = cfg["net"]
    return Net(W, "net", layer_table(cfg, "net"), n["fc"], n["final_activation"], quant_bits,
               calibrate)


def expert_input(cfg: dict, x: torch.Tensor, i: int) -> torch.Tensor:
    """Expert i's 20-channel slices of a [B, 20 S, r, r, r] statistics grid."""
    scales = expert_scales(cfg)[i]
    lo = 20 * min(scales)
    return x[:, lo:lo + 20 * len(scales)]


def serve_grid(cfg: dict, W: dict, grid: torch.Tensor, quant_bits=None) -> dict:
    """A [B, r, r, r, 20 S] statistics grid -> {"normals": [E, B, 3] every
    expert's (or [1, B, 3] the MS network's), "probs": [B, E] or None}."""
    x = grid.permute(0, 4, 1, 2, 3).contiguous()
    if cfg["model"] != "experts_n_est":
        return {"normals": ms_net(cfg, W, quant_bits)(x)[None], "probs": None}
    probs = torch.softmax(manager(cfg, W, quant_bits)(x), dim=-1)
    normals = [expert(cfg, W, i, quant_bits)(expert_input(cfg, x, i))
               for i in range(cfg["n_experts"])]
    return {"normals": torch.stack(normals), "probs": probs}
