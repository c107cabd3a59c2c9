"""Common model scaffolding.

Counterpart of `nestinet_tpu/models/base.py`: the GMM's w/mu/sigma live on
the model's device as (non-persistent) buffers, `mups_grid` computes the
statistics grid, and `FCHead` is the reference's FC head (`:120-144`):
hidden `DenseBN` layers with BN and ReLU and optional dropout, a last layer
without BN.  Every
forward takes `training` and the scheduled `bn_momentum`, as JAX's
`apply(..., is_training, bn_momentum)`.  `build_model` initializes the
weights (`init_params`) from a `torch.Generator`, unless its caller loads
every one of them (`infer/predict.py::load_run`).

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
from ..ops.nn import Backbone, DenseBN, Dropout, dropout
from .losses import normal_loss

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.bfloat16}


class ModelBase(nn.Module):
    # What serving asks of a model (`infer/predict.py::serve_job`), with
    # `serve_dense`:
    #   n_experts    the routes a routed call sends each patch through (0: the
    #                model is served dense only)
    #   gate_rows    the rows of the gate that picks a patch's route
    #   gate_files   by `moe_inference`, the suffix of the file of the gate's
    #                columns, written beside `.experts` (the routes' ids); a
    #                mode not named writes `.normals` alone
    #   routes_stat  the stats' key of the patches each route served, a list,
    #   route_names  or a dict by these names
    #   widths_hint  told when a checkpoint's widths do not fit the model
    n_experts = 0
    gate_rows = 0
    gate_files: dict = {}
    routes_stat = None
    route_names = None
    widths_hint = ""

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

    def sharded_parameters(self) -> list:
        """The parameters of this rank's expert shard: none but in a mixture
        of experts sharded over an expert axis (`models/experts.py`)."""
        return []

    def is_shard_key(self, key: str) -> bool:
        """True when state dict `key` belongs to this rank's expert shard."""
        return False

    def serve_dense(self, grid: torch.Tensor, real: int) -> tuple:
        """What a dense call serves of a padded batch's grid whose first
        `real` rows are patches: (normals [real, 3], the routes' ids [real]
        and the gate [real, G] where the model writes them, else None, and
        the host's count of the patches a route where the ids do not give
        it, else None)."""
        return self.predict_normals(self.forward_grid(grid))[:real], None, None, None

    def mups_grid(self, points: torch.Tensor, n_eff: torch.Tensor) -> torch.Tensor:
        """[B, res, res, res, 20 * n_scales] statistics grid, computed in
        float32 and cast once to the compute dtype (JAX `experts.py:150-152`)."""
        return mups(
            points.to(torch.float32), n_eff,
            self.gmm_w, self.gmm_mu, self.gmm_sigma,
            n_scales=self.cfg.n_scales, resolution=self.resolution,
        ).to(self.compute_dtype)


FINAL_ACTIVATIONS = (None, "relu")


class FCHead(nn.Module):
    """`fc1..fc{n}` hidden DenseBN layers (BN + ReLU), each followed in
    training by dropout at `dropout_rate` (JAX `fc_head`, `base.py:120-145`),
    then `fc{n+1}` without BN and with the named `final_activation` (None
    or "relu").  `final_init` = (stddev, bias) initializes the last layer
    with haiku's TruncatedNormal(stddev) (cut at 2 standard deviations)
    and a constant bias, instead of xavier and zero."""

    def __init__(self, cin: int, hidden, final_units: int, *, final_activation=None,
                 dropout_rate: float = 0.0, final_init: tuple | None = None):
        super().__init__()
        if final_activation not in FINAL_ACTIVATIONS:
            raise ValueError(f"final_activation must be one of {FINAL_ACTIVATIONS}")
        self.n_layers = len(hidden) + 1
        self.dropout_rate = dropout_rate
        self.final_init = final_init
        c = cin
        for i, units in enumerate(hidden):
            self.add_module(f"fc{i + 1}", DenseBN(c, units, bn=True))
            c = units
        self.add_module(f"fc{self.n_layers}",
                        DenseBN(c, final_units, bn=False, relu=final_activation == "relu"))

    def forward(self, x: torch.Tensor, training: bool = False, bn_momentum=None,
                dropout_masks: Dropout | None = None) -> torch.Tensor:
        for i in range(self.n_layers - 1):
            x = getattr(self, f"fc{i + 1}")(x, training, bn_momentum)
            if self.dropout_rate > 0.0:
                x = dropout(x, self.dropout_rate, training, dropout_masks)
        return getattr(self, f"fc{self.n_layers}")(x, training, bn_momentum)

    @torch.no_grad()
    def init_final_(self, generator: torch.Generator) -> None:
        stddev, bias = self.final_init
        last = getattr(self, f"fc{self.n_layers}").linear
        torch.nn.init.trunc_normal_(last.w, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                    generator=generator)
        last.b.fill_(bias)


class ConvNet(nn.Module):
    """A backbone followed by an FC head, on an NCDHW grid; `head` takes
    FCHead's keyword arguments."""

    def __init__(self, spec, cin: int, resolution: int, hidden, final_units: int, **head):
        super().__init__()
        self.backbone = Backbone(spec, cin, resolution)
        self.head = FCHead(self.backbone.out_features, hidden, final_units, **head)

    def forward(self, x: torch.Tensor, training: bool = False, bn_momentum=None,
                dropout_masks: Dropout | None = None) -> torch.Tensor:
        return self.head(self.backbone(x, training, bn_momentum), training, bn_momentum,
                         dropout_masks)


class SingleNetNormEst(ModelBase):
    """One ConvNet on the whole [B, r, r, r, 20 * n_scales] grid: the
    backbone `spec`, then FC 1024/256/128 with dropout at rate 0.3 (the
    reference's keep_prob 0.7) and 3 linear outputs, returned in float32
    (JAX `models/ss.py`, `models/ms.py`).  The haiku tree has no prefix:
    `incep{i}/...` and `fc{i}/...` are `net.backbone.*` and `net.head.*`."""

    DROPOUT_RATE = 0.3
    HAIKU_NETS = {"net": ""}  # {torch net: haiku prefix} (convert.py)

    def __init__(self, cfg, gmm, spec):
        super().__init__(cfg, gmm)
        self.net = ConvNet(spec, 20 * cfg.n_scales, self.resolution, (1024, 256, 128), 3,
                           dropout_rate=self.DROPOUT_RATE)

    def forward_grid(self, grid: torch.Tensor, training: bool = False, bn_momentum=None,
                     dropout_masks: Dropout | None = None) -> dict:
        n_est = self.net(grid.permute(0, 4, 1, 2, 3), training, bn_momentum, dropout_masks)
        return {"n_pred": n_est.to(torch.float32)}

    def forward(self, points: torch.Tensor, n_eff: torch.Tensor, training: bool = False,
                bn_momentum=None, dropout_masks: Dropout | None = None) -> dict:
        return self.forward_grid(self.mups_grid(points, n_eff), training, bn_momentum,
                                 dropout_masks)

    def loss(self, outputs: dict, batch: dict):
        """(scalar loss, {"cos_ang": [B]}) against batch["normals"]."""
        loss, cos_ang = normal_loss(outputs["n_pred"], batch["normals"], self.cfg.loss_type)
        return loss, {"cos_ang": cos_ang}

    @staticmethod
    def predict_normals(outputs: dict) -> torch.Tensor:
        return outputs["n_pred"]


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
    for m in module.modules():
        if isinstance(m, FCHead) and m.final_init is not None:
            m.init_final_(generator)
