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
"""

from __future__ import annotations

import torch

from . import backbones
from .base import ConvNet, ModelBase
from .losses import switching_loss

NOISE_SWITCH_THRESHOLD = 0.015  # `ms_sw_n_est.py:82`
NOISE_HEAD_INIT_STDDEV = 1e-3


class SwitchingNormEst(ModelBase):
    # {torch net: haiku prefix} (convert.py), in JAX's call order
    HAIKU_NETS = {"noise": "noise_", "large": "large_", "small": "small_"}

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
        [B, r, r, r, 40] grid (the model has no dropout)."""
        x = grid.permute(0, 4, 1, 2, 3)
        small, large = x[:, :20], x[:, 20:]
        noise = self.noise(large, training, bn_momentum)[:, 0]
        n_large = self.large(large, training, bn_momentum)
        n_small = self.small(small, training, bn_momentum)
        n_est = torch.where((noise < NOISE_SWITCH_THRESHOLD)[:, None], n_small, n_large)
        return {"n_pred": n_est.to(torch.float32), "noise_pred": noise.to(torch.float32)}

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
