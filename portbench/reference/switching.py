"""The plain reference of the noise-switching model (`ms_sw_n_est`), in
float32 PyTorch, built from `model.py`'s blocks (`Net`) and a
configuration file of `portbench/configs/`: the layer table `net.backbone`,
which all three CNNs share, the normal CNNs' head `net.fc`, the noise
CNN's head `noise_head.fc` with its `final_activation`, and
`noise_threshold`.  It imports nothing of the program.

Nesti-Net's `models/ms_sw_n_est.py` on a two-radius statistics grid
[B, r, r, r, 40] (20 channels a radius, the small radius first):
  * the noise CNN reads the large radius's channels and gives one noise
    estimate a patch, through a ReLU;
  * the small and the large normal CNN each read their own radius's
    channels and give a normal;
  * the switch: the small radius's normal where noise < noise_threshold
    (0.015, `ms_sw_n_est.py:82`), compared in float32, else the large
    radius's.
`serve_grid` gives the noise estimate, both branches' normals and the
switch's choice.

Departures from `ms_sw_n_est.py`, all as `model.py` notes them for the
other models:
  * inference only: BatchNorm over the debiased EMA moments of the
    weights (mean = ema_mean / (1 - bias), var = ema_var / (1 - bias),
    eps 1e-3), where the original reads TensorFlow's moving averages; no
    training graph and no loss;
  * the statistics grid comes from `mups.py` and the patches from
    `extract.py`, not from the original's input pipeline;
  * the flatten before the FC heads in (D, H, W, C) order;
  * the noise head's initialisation (the original's small last layer and
    bias at the threshold) is not modelled: the weights are given.

`quant_bits` (the control only) folds and quantizes every layer of the
three CNNs as `model.py` does.  `calibrate` (the benchmark's weights only)
sets each BatchNorm's moments from its own input, as `model.py` does.
"""

from __future__ import annotations

import math

import torch

from .model import Net, _net_specs, layer_table

NETS = ("noise", "large", "small")  # the program's order
BRANCHES = ("small", "large")  # branch 0 reads the small radius, 1 the large


def _head(cfg: dict, name: str) -> dict:
    return cfg["noise_head"] if name == "noise" else cfg["net"]


def param_specs(cfg: dict) -> list:
    """[(key, shape, kind)] of every tensor of the three CNNs, in the
    program's order, each CNN's keys under its name."""
    res, spec = cfg["num_gaussians"], layer_table(cfg, "net")
    return [s for name in NETS for s in _net_specs(name, spec, 20, res, _head(cfg, name)["fc"])]


def n_parameters(cfg: dict) -> int:
    """Trainable values: kernels, biases, BatchNorm gamma and beta."""
    return sum(math.prod(shape) for _, shape, kind in param_specs(cfg)
               if kind in ("w", "b", "gamma", "beta"))


def nets(cfg: dict, W: dict, quant_bits=None, calibrate=False) -> dict:
    """{"noise", "large", "small": Net} over the weights `W`."""
    spec = layer_table(cfg, "net")
    return {name: Net(W, name, spec, _head(cfg, name)["fc"],
                      _head(cfg, name)["final_activation"], quant_bits, calibrate)
            for name in NETS}


def net_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """The 20 channels of a [B, 40, r, r, r] grid that CNN `name` reads."""
    return x[:, :20] if name == "small" else x[:, 20:]


def serve_grid(cfg: dict, W: dict, grid: torch.Tensor, quant_bits=None) -> dict:
    """A [B, r, r, r, 40] statistics grid -> {"noise": [B], "normals":
    [2, B, 3] (branch 0 the small radius, 1 the large), "branch": [B] the
    switch's choice, "normal": [B, 3] the chosen branch's normal}."""
    x = grid.permute(0, 4, 1, 2, 3).contiguous()
    n = nets(cfg, W, quant_bits)
    noise = n["noise"](net_input(x, "noise"))[:, 0]
    normals = torch.stack([n[b](net_input(x, b)) for b in BRANCHES])
    branch = torch.where(noise < cfg["noise_threshold"], 0, 1)
    return {"noise": noise, "normals": normals, "branch": branch,
            "normal": normals[branch, torch.arange(x.shape[0], device=x.device)]}
