"""Common model scaffolding.

Counterpart of `nestinet_tpu/models/base.py`: the GMM's w/mu/sigma live on
the model's device as (non-persistent) buffers, `mups_grid` computes the
statistics grid, and `FCHead` is the reference's FC head (`:120-144`):
hidden `DenseBN` layers with BN and ReLU, a last layer without BN.  Every
forward takes `training` and the scheduled `bn_momentum`, as JAX's
`apply(..., is_training, bn_momentum)`.  A model initializes its weights
when it is built (`init_params`), from a `torch.Generator`.

Serving modes, from the config as in JAX (`:42-53`): `compute_dtype` is
bfloat16 for "bfloat16" and "int8" and float32 otherwise (parameters stay
float32 and are cast per op); `quantize` (int8) and `fold_bn` say what
`infer/predict.py::load_run` does to the weights after loading them.  The
MuPS statistics stay float32 in every mode.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.mups import mups
from ..ops.nn import Backbone, DenseBN

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.bfloat16}


class ModelBase(nn.Module):
    def __init__(self, cfg, gmm):
        super().__init__()
        self.cfg = cfg
        self.gmm = gmm
        self.resolution = gmm.resolution
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, "
                             f"got {cfg.compute_dtype!r}")
        self.compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.quantize = cfg.compute_dtype == "int8"
        self.fold_bn = bool(getattr(cfg, "fold_bn", False))
        # cfg.mups_impl is read from config.json and ignored: the port has no
        # implementation switch; ops.mups runs the CUDA kernel on a CUDA
        # tensor and the plain version on a CPU tensor.
        w, mu, sigma = gmm.astuple()
        self.register_buffer("gmm_w", torch.from_numpy(w), persistent=False)
        self.register_buffer("gmm_mu", torch.from_numpy(mu), persistent=False)
        self.register_buffer("gmm_sigma", torch.from_numpy(sigma), persistent=False)

    def mups_grid(self, points: torch.Tensor, n_eff: torch.Tensor) -> torch.Tensor:
        """[B, res, res, res, 20 * n_scales] statistics grid, computed in
        float32 and cast once to the compute dtype (JAX `experts.py:150-152`)."""
        return mups(
            points.to(torch.float32), n_eff,
            self.gmm_w, self.gmm_mu, self.gmm_sigma,
            n_scales=self.cfg.n_scales, resolution=self.resolution,
        ).to(self.compute_dtype)


class FCHead(nn.Module):
    """`fc1..fc{n}` hidden DenseBN layers (BN + ReLU), then `fc{n+1}`
    without BN and with an optional final ReLU."""

    def __init__(self, cin: int, hidden, final_units: int, *, final_relu: bool):
        super().__init__()
        self.n_layers = len(hidden) + 1
        c = cin
        for i, units in enumerate(hidden):
            self.add_module(f"fc{i + 1}", DenseBN(c, units, bn=True))
            c = units
        self.add_module(
            f"fc{self.n_layers}", DenseBN(c, final_units, bn=False, relu=final_relu)
        )

    def forward(self, x: torch.Tensor, training: bool = False, bn_momentum=None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"fc{i + 1}")(x, training, bn_momentum)
        return x


class ConvNet(nn.Module):
    """A backbone followed by an FC head, on an NCDHW grid."""

    def __init__(self, spec, cin: int, resolution: int, hidden, final_units: int,
                 *, final_relu: bool):
        super().__init__()
        self.backbone = Backbone(spec, cin, resolution)
        self.head = FCHead(
            self.backbone.out_features, hidden, final_units, final_relu=final_relu
        )

    def forward(self, x: torch.Tensor, training: bool = False, bn_momentum=None) -> torch.Tensor:
        return self.head(self.backbone(x, training, bn_momentum), training, bn_momentum)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Xavier-uniform kernels and zero biases, as the reference initialises
    them (`nestinet_tpu/ops/nn.py:36`, VarianceScaling(1, fan_avg,
    uniform) on DHWIO fans): each kernel uniform in +-sqrt(6 / (fan_in +
    fan_out)), drawn from `generator` in parameter order; BatchNorm
    parameters and state keep their defaults."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w":
            receptive = math.prod(p.shape[2:]) if p.dim() > 2 else 1
            fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            p.uniform_(-limit, limit, generator=generator)
        elif leaf == "b":
            p.zero_()
