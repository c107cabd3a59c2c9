"""Operations and bytes from the layer tables of `portbench/configs/`.

A conv's operations are 2 x (output cells) x cout x cin x k^3, every tap
of the SAME window counted, padded ones included, as
`torch.utils.flop_counter.FlopCounterMode` counts them; a linear's are
2 x cin x cout.  Pools, BatchNorm, bias, softmax and the MuPS statistics
are not counted.  The int8 kernel's bound is the larger of its operations
at the int8 peak and its bytes at the HBM rate, each input byte read once
and each output byte written once: the bfloat16 activation in and out,
the packed int8 kernel (channels padded as the kernel packs them), the
float32 scale and bias (`chip_smoke.py::int8_case` and `bound`).
"""

from __future__ import annotations

from ..reference.model import expert_scales, layer_table
from .peaks import HBM_BYTES_PER_S, INT8_OPS_PER_S


def net_layers(spec: list, cin: int, res: int, fc: list) -> list:
    """[(cin, cout, k, r)] of every conv (r: its grid side) and FC (k = r = 1)."""
    out, c, r = [], cin, res
    for entry in spec:
        if entry[0] == "maxpool":
            r = -(-r // entry[2])
            continue
        n, (k1, k2) = entry[1], entry[2]
        out += [(c, n, 1, r), (n, n // 2, k1, r), (n, n // 2, k2, r), (c, n, 1, r)]
        c = n + 2 * (n // 2) + n
    c = c * r ** 3
    for units in fc:
        out.append((c, units, 1, 1))
        c = units
    return out


def model_layers(cfg: dict) -> dict:
    """{"manager": [...], "expert0": [...], ...} or {"net": [...]}."""
    S, res = len(cfg["patch_radius"]), cfg["num_gaussians"]
    if cfg["model"] != "experts_n_est":
        return {"net": net_layers(layer_table(cfg, "net"), 20 * S, res, cfg["net"]["fc"])}
    out = {"manager": net_layers(layer_table(cfg, "manager"), 20 * S, res,
                                 cfg["manager"]["fc"])}
    for i, scales in enumerate(expert_scales(cfg)):
        s = len(scales)
        out[f"expert{i}"] = net_layers(layer_table(cfg, "expert", s), 20 * s, res,
                                       cfg["expert"]["fc"])
    return out


def layer_ops(B: int, cin: int, cout: int, k: int, r: int) -> float:
    return 2.0 * B * r ** 3 * cout * cin * k ** 3


def gflop_per_patch(cfg: dict) -> dict:
    """GFLOP of one patch through each part of the model."""
    return {part: sum(layer_ops(1, *layer) for layer in layers) / 1e9
            for part, layers in model_layers(cfg).items()}


def padded_channels(cin: int) -> int:
    for c in (16, 32, 64):
        if cin <= c:
            return c
    return -(-cin // 128) * 128


def int8_bound_s(B: int, cin: int, cout: int, k: int, r: int) -> float:
    """The least time of one int8 conv or linear launch, in seconds."""
    ops = layer_ops(B, cin, cout, k, r)
    nbytes = B * r ** 3 * (cin + cout) * 2 + cout * k ** 3 * padded_channels(cin) + cout * 8 + 8
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
