"""Operations of the noise-switching model from its configuration's layer
table, counted as `flops.py` counts them (every tap of the SAME window)."""

from __future__ import annotations

from ..reference.model import layer_table
from ..reference.switching import NETS, _head
from .flops import layer_ops, net_layers


def model_layers(cfg: dict) -> dict:
    """{"noise": [...], "large": [...], "small": [...]}: each CNN's
    [(cin, cout, k, r)] on its radius's 20 channels."""
    spec = layer_table(cfg, "net")
    return {name: net_layers(spec, 20, cfg["num_gaussians"], _head(cfg, name)["fc"])
            for name in NETS}


def gflop_per_patch(cfg: dict) -> dict:
    """GFLOP of one patch through each CNN."""
    return {name: sum(layer_ops(1, *layer) for layer in layers) / 1e9
            for name, layers in model_layers(cfg).items()}


def served_gflop(cfg: dict, n_patches: int, branch_rows: dict) -> float:
    """GFLOP of a routed job: the noise CNN on every patch and each patch's
    branch (`branch_rows`: the program's {"small_scale", "large_scale"})."""
    g = gflop_per_patch(cfg)
    return (n_patches * g["noise"] + branch_rows["small_scale"] * g["small"]
            + branch_rows["large_scale"] * g["large"])
