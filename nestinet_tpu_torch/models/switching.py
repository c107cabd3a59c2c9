"""Noise-switching normal estimation (ablation model).

Counterpart of `nestinet_tpu/models/switching.py`: two patch radii.  A
noise CNN reads the large radius's grid and estimates one noise level per
patch (FC 1024/256/128/1, ReLU output); two normal CNNs read the small and
the large radius's grids; the hard switch `noise < 0.015` takes the
small-scale normal for clean patches and the large-scale one for noisy
patches (`:23-97`).  The three CNNs share `SW_BACKBONE`.  The noise head's
last layer starts at TruncatedNormal(stddev=1e-3) weights and a bias of
0.015, JAX's init-only change that keeps every sample's ReLU alive
(`:37-57`).  The haiku tree prefixes each CNN's modules with `noise_`,
`large_` or `small_` (`noise_incep0/...`, `noise_fc1/...`); here they are
the `noise`, `large` and `small` ConvNets.

Dense serving (`forward_grid`) runs the three CNNs on every patch, as JAX
does.  Routed serving (`infer/predict.py::SparseMoeRouter`) runs the noise
CNN on the whole padded batch (`gate`), decides each patch's branch on the
host from the noise (`route`: 0, the small radius, where noise < 0.015,
else 1), and runs each patch through its branch only (`expert_on_grid`),
which gives the dense path's normal.  Both compare the noise in float32,
which decides as bfloat16 does on every bfloat16 value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import profiling
from . import backbones
from .base import ConvNet, ModelBase
from .losses import switching_loss

NOISE_SWITCH_THRESHOLD = 0.015  # `ms_sw_n_est.py:82`
NOISE_HEAD_INIT_STDDEV = 1e-3


class SwitchingNormEst(ModelBase):
    # {torch net: haiku prefix} (convert.py), in JAX's call order
    HAIKU_NETS = {"noise": "noise_", "large": "large_", "small": "small_"}
    # served (`ModelBase`): the router's routes are the branches, 0 the small
    # radius and 1 the large, its gate one row, the noise, written to `.noise`
    # when routed; dense writes `.normals` alone, as JAX does
    n_experts = 2
    gate_rows = 1
    gate_files = {"sparse": "noise"}
    routes_stat = "branch_rows"
    route_names = ("small_scale", "large_scale")
    widths_hint = (" The switching model's CNNs take models/backbones.py::SW_BACKBONE, which "
                   "config.json does not record: a run trained with it narrowed (as "
                   "nestinet_tpu_torch/testdata/jax_run_switching) is served with the same "
                   "narrowing.")

    def __init__(self, cfg, gmm):
        super().__init__(cfg, gmm)
        if cfg.n_scales != 2:
            raise ValueError("the switching model takes exactly two patch radii")
        res, hidden = self.resolution, (1024, 256, 128)
        self.noise = ConvNet(backbones.SW_BACKBONE, 20, res, hidden, 1, final_activation="relu",
                             final_init=(NOISE_HEAD_INIT_STDDEV, NOISE_SWITCH_THRESHOLD))
        self.large = ConvNet(backbones.SW_BACKBONE, 20, res, hidden, 3)
        self.small = ConvNet(backbones.SW_BACKBONE, 20, res, hidden, 3)

    def forward_grid(self, grid: torch.Tensor, training: bool = False, bn_momentum=None,
                     dropout_masks=None) -> dict:
        """{"n_pred": [B, 3], "noise_pred": [B]} in float32 from a
        [B, r, r, r, 40] grid: all three CNNs on every patch (the model has
        no dropout)."""
        noise = self.gate(grid, training, bn_momentum)[0]
        n_large = self.expert_on_grid(1, grid, training, bn_momentum)
        n_small = self.expert_on_grid(0, grid, training, bn_momentum)
        n_est = torch.where((noise < NOISE_SWITCH_THRESHOLD)[:, None], n_small, n_large)
        return {"n_pred": n_est, "noise_pred": noise}

    def serve_dense(self, grid: torch.Tensor, real: int) -> tuple:
        """All three CNNs on every patch (`ModelBase.serve_dense`): the
        normals, and the patches a branch counted from the noise."""
        outputs = self.forward_grid(grid)
        small = int(profiling.fetch("fetch.outputs",
                                    (outputs["noise_pred"][:real] < NOISE_SWITCH_THRESHOLD).sum()))
        return self.predict_normals(outputs)[:real], None, None, np.array((small, real - small))

    def gate(self, grid: torch.Tensor, training: bool = False, bn_momentum=None) -> torch.Tensor:
        """The noise CNN on the large radius's channels of a [B, r, r, r, 40]
        grid -> the float32 noise estimate [1, B]."""
        x = grid[..., 20:].permute(0, 4, 1, 2, 3)
        return self.noise(x, training, bn_momentum)[:, 0].to(torch.float32)[None]

    @staticmethod
    def route(gate: np.ndarray) -> np.ndarray:
        """Each patch's branch from the host copy of its noise [1, n]: 0 (the
        small radius) where noise < 0.015 in float32, else 1, a NaN too, as
        `forward_grid`'s `torch.where`."""
        return np.where(gate[0] < np.float32(NOISE_SWITCH_THRESHOLD), 0, 1)

    def expert_on_grid(self, i: int, grid: torch.Tensor, training: bool = False,
                       bn_momentum=None) -> torch.Tensor:
        """Branch `i` (0 small, 1 large) on its radius's 20 channels of a
        [b, r, r, r, 40] grid -> float32 normals [b, 3]."""
        x = grid[..., 20 * i:20 * (i + 1)].permute(0, 4, 1, 2, 3)
        return (self.small, self.large)[i](x, training, bn_momentum).to(torch.float32)

    def forward(self, points: torch.Tensor, n_eff: torch.Tensor, training: bool = False,
                bn_momentum=None, dropout_masks=None) -> dict:
        return self.forward_grid(self.mups_grid(points, n_eff), training, bn_momentum)

    def loss(self, outputs: dict, batch: dict):
        """(noise MSE + angular loss, {"cos_ang": [B], "noise_loss"})
        against batch["normals"] and batch["noise"]."""
        loss, cos_ang, noise_loss = switching_loss(
            outputs["noise_pred"], batch["noise"], outputs["n_pred"], batch["normals"],
            self.cfg.loss_type,
        )
        return loss, {"cos_ang": cos_ang, "noise_loss": noise_loss}

    @staticmethod
    def predict_normals(outputs: dict) -> torch.Tensor:
        return outputs["n_pred"]
