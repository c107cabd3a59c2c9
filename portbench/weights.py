"""The benchmark's weights: made from the seed on the run's device, in a
few large draws, for the tensor layout that `reference/model.py` names.

Kernels are xavier-uniform (+-sqrt(6 / (fan_in + fan_out))); conv and FC
biases uniform in +-0.03, BatchNorm beta in B +- 0.03, B being the
configuration's `assumed.bn_beta`; BatchNorm bias b in (0.1, 0.9) and
gamma in (0.8, 1.2), as `chip_smoke.py::randomize_bn` draws them.

`calibrate` then sets every BatchNorm's moments, layer by layer, to those
of its input on real patches (each EMA stored times 1 - b), so that each
layer passes on how patches differ: with moments drawn at random (as
`randomize_bn` draws them) a deep random network maps every patch to
nearly the same features, and any rounding decides the route.  A mixture
of experts' manager then has its last layer rescaled as
`chip_smoke.py::spread_manager_logits` does, so that its logits on those
patches are about 1 + 2 N(0, 1) per expert.

B, the shift after each normalisation, sets how much of a layer passes
its ReLU.  At 0 half is cut at every layer, and the random network
amplifies its first layer's rounding some fivefold by the manager's
logits: an int8 manager then reroutes a third of the patches, and one
whose probabilities are wrong reads no more than 2.5 times that.  At 1
about 84% passes and an int8 manager reroutes a sixth; but a bf16
network then rounds each conv's large common part before the BatchNorm
subtracts it, and reads as far from float32 as int8 does.  So the
mixture of experts, whose routing the check reads, takes 1, and the
multi-scale network, served in bf16, takes 0.
"""

from __future__ import annotations

import math

import torch

from .reference import model as ref


def make(cfg: dict, seed: int, device) -> dict:
    """{key: float32 tensor on `device`} for every tensor of the model."""
    specs = ref.param_specs(cfg)
    beta = float(cfg["assumed"]["bn_beta"])
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    W, at = {}, 0
    for (key, shape, kind), n in zip(specs, sizes):
        x = u[at:at + n].view(shape)
        at += n
        if kind == "w":
            receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
            limit = math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
            x = (2 * x - 1) * limit
        elif kind == "b":
            x = (2 * x - 1) * 0.03
        elif kind == "beta":
            x = beta + (2 * x - 1) * 0.03
        elif kind == "gamma":
            x = 0.8 + 0.4 * x
        elif kind == "ema_mean":
            x = (2 * x - 1) * math.sqrt(3.0) * 0.1
        elif kind == "ema_var":
            x = 0.5 + x
        elif kind == "bn_bias":
            x = 0.1 + 0.8 * x
        W[key] = x.contiguous()
    for key, _, kind in specs:
        if kind in ("ema_mean", "ema_var"):
            W[key] = W[key] * (1.0 - W[key.rsplit(".", 1)[0] + ".bias"])
    return W


def calibrate(cfg: dict, W: dict, grid: torch.Tensor) -> dict:
    """Set every BatchNorm's moments in place from the reference's forward on
    the patches of `grid` [B, r, r, r, C], then spread a manager's logits;
    returns what `spread_manager` returns ({} without a manager)."""
    x = grid.permute(0, 4, 1, 2, 3).contiguous()
    with torch.no_grad():
        if cfg["model"] != "experts_n_est":
            ref.ms_net(cfg, W, calibrate=True)(x)
            return {}
        ref.manager(cfg, W, calibrate=True)(x)
        for i in range(cfg["n_experts"]):
            ref.expert(cfg, W, i, calibrate=True)(ref.expert_input(cfg, x, i))
    return spread_manager(cfg, W, grid)


def spread_manager(cfg: dict, W: dict, grid: torch.Tensor) -> dict:
    """Rescale the manager's last layer in place so that its logits on the
    patches of `grid` [B, r, r, r, C] are about 1 + 2 N(0, 1) per expert;
    returns the logits' standard deviations before and the scales."""
    spread = {}
    net = ref.manager(cfg, W)
    last = f"manager.head.fc{net.n_fc}.linear"
    with torch.no_grad():
        h = net.head_hidden(net.backbone(grid.permute(0, 4, 1, 2, 3).contiguous()))
        z = h @ W[f"{last}.w"].t()
        scale = 2.0 / z.std(dim=0)
        spread.update(z_std=z.std(dim=0).tolist(), scale=scale.tolist())
        W[f"{last}.w"] = W[f"{last}.w"] * scale[:, None]
        W[f"{last}.b"] = 1.0 - z.mean(dim=0) * scale
    return spread
