"""The noise-switching model's weights for the benchmark: each of its three
CNNs drawn from the seed as `weights.py::make` draws a network (its own
stream of the seed), every BatchNorm's moments then set from its own input
on real patches as `weights.py::calibrate` sets them, and the noise CNN's
last layer rescaled as `chip_smoke.py::spread_noise_head` does, so that its
estimates on those patches are about 0.015 + 0.01 N(0, 1) with the median
at the switch: about half the patches take each branch."""

from __future__ import annotations

import torch

from . import weights
from .reference import switching as ref


def _one_net(cfg: dict, name: str) -> dict:
    """The configuration of CNN `name` alone, as `weights.make` reads a
    multi-scale network's: one radius (20 channels), the shared backbone,
    its own head."""
    return {"model": "ms_norm_est", "patch_radius": cfg["patch_radius"][:1],
            "num_gaussians": cfg["num_gaussians"], "assumed": cfg["assumed"],
            "net": dict(ref._head(cfg, name), backbone=cfg["net"]["backbone"])}


def make(cfg: dict, seed: int, device) -> dict:
    """{key: float32 tensor on `device`} for every tensor of the model."""
    W = {}
    for k, name in enumerate(ref.NETS):
        drawn = weights.make(_one_net(cfg, name), 3 * int(seed) + k, device)
        W.update({name + key[len("net"):]: v for key, v in drawn.items()})
    return W


def calibrate(cfg: dict, W: dict, grid: torch.Tensor) -> dict:
    """Set every BatchNorm's moments in place from the reference's forward
    on the patches of `grid` [B, r, r, r, 40], then spread the noise
    estimates; returns what `spread_noise` returns."""
    x = grid.permute(0, 4, 1, 2, 3).contiguous()
    with torch.no_grad():
        for name, net in ref.nets(cfg, W, calibrate=True).items():
            net(ref.net_input(x, name))
    return spread_noise(cfg, W, grid)


def spread_noise(cfg: dict, W: dict, grid: torch.Tensor) -> dict:
    """Rescale the noise CNN's last layer in place so that its estimates on
    the patches of `grid` are about threshold + 0.01 N(0, 1), the threshold
    falling between the two middle patches; returns the standard deviation
    before, the scale and the small branch's share of the patches after."""
    x = grid.permute(0, 4, 1, 2, 3).contiguous()
    net = ref.nets(cfg, W)["noise"]
    last = f"noise.head.fc{net.n_fc}.linear"
    with torch.no_grad():
        h = net.head_hidden(net.backbone(ref.net_input(x, "noise")))
        z = (h @ W[f"{last}.w"].t())[:, 0]
        scale = 0.01 / z.std()
        zs = (z * scale).sort().values
        mid = zs[(len(zs) - 1) // 2:len(zs) // 2 + 1].mean()
        W[f"{last}.w"] = W[f"{last}.w"] * scale
        W[f"{last}.b"] = torch.full_like(W[f"{last}.b"], cfg["noise_threshold"]) - mid
        noise = ref.nets(cfg, W)["noise"](ref.net_input(x, "noise"))[:, 0]
    return {"z_std": float(z.std()), "scale": float(scale),
            "small_share": float((noise < cfg["noise_threshold"]).float().mean())}
