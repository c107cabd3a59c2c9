"""Nesti-Net mixture-of-experts normal estimation (flagship model).

Counterpart of `nestinet_tpu/models/experts.py`:
  * MuPS: per-radius 3DmFV grids channel-concatenated;
  * a manager CNN + FC 1024/256/128/n_experts, ReLU THEN a float32 softmax,
    giving [n_experts, B] probabilities (`:85-93`);
  * n_experts expert CNNs, each on its scales' 20-channel slice starting at
    min(scales)*20, first inception width 128 // len(scales) (42 for the
    3-scale expert) (`:66-73`, `:50`);
  * dense inference (`forward_grid`): every expert runs on every patch,
    the argmax expert's normal is kept (first maximum on ties, as
    jnp.argmax); routed inference (`infer/predict.py::SparseMoeRouter`)
    runs `manager_probs` and then each patch's argmax expert only, through
    the same two grid-level methods;
  * training (`forward(..., training=True, bn_momentum=m)`) runs every
    expert on every patch, because the loss needs all of them; `loss`
    wraps `moe_loss` with the config's loss and expert loss types
    (`:261-269`);
  * in every compute dtype the grid is cast once (`mups_grid`), the
    manager's softmax runs in float32 (`:92`) and the experts return
    float32 (`:112`).  Under int8 the per-tensor activation scales depend
    on which patches share a call, so a routed expert run gives slightly
    other numbers than the dense batch; the router forms JAX's runs, so
    they are JAX's numbers.

The reference stacks the experts of one scale count and vmaps them; here
they are a `ModuleList` in reference expert order, which computes the same
function.  `expert_groups` keeps the reference's grouping because the
haiku checkpoint is laid out by it (`convert.py`) and expert parallelism
shards by it.

Expert parallelism (`shard_experts`, called by `train/mesh.py::
shard_model`): a model built for an expert rank is built whole from the
seed, so its weights are the full model's bit for bit, and then keeps only
the experts that rank holds; the others give way to an empty placeholder.
Its forward runs the manager and its own experts on its rows and gathers
the sharded experts' [E, B, 3] normals over the expert group into
reference expert order; the state dict and the parameters hold its own
experts only, and `full_state_keys` / `full_parameter_names` keep the
whole model's order for a checkpoint in the one-process layout.
"""

from __future__ import annotations

import dataclasses

import torch

from . import backbones
from .base import ConvNet, ModelBase
from .losses import moe_loss


@dataclasses.dataclass
class ExpertGroup:
    """Experts sharing an architecture (the same scale count)."""

    n_scales: int
    indices: list  # expert ids, in reference order
    starts: list  # channel-slice starts into the MuPS grid

    @property
    def channels(self) -> int:
        return 20 * self.n_scales

    @property
    def first_width(self) -> int:
        return 128 // self.n_scales


class HeldElsewhere(torch.nn.Module):
    """The place of an expert that another rank of the expert group holds."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this expert is held by another rank of the expert group")


def expert_groups(cfg) -> list[ExpertGroup]:
    """The reference's grouping: by scale count, groups in ascending scale
    count, members in expert order (`experts.py:66-73`)."""
    assignment = cfg.expert_assignment
    if len(assignment) != cfg.n_experts:
        raise ValueError("expert_dict size must equal n_experts")
    by_key: dict[int, ExpertGroup] = {}
    for i in range(cfg.n_experts):
        scales = assignment[i]
        g = by_key.setdefault(len(scales), ExpertGroup(len(scales), [], []))
        g.indices.append(i)
        g.starts.append(min(scales) * 20)
    return [by_key[k] for k in sorted(by_key)]


class ExpertsNormEst(ModelBase):
    def __init__(self, cfg, gmm):
        super().__init__(cfg, gmm)
        res = self.resolution
        if res not in (3, 8):
            raise ValueError("the MoE model supports 3^3 or 8^3 Gaussian grids")
        self.n_experts = cfg.n_experts
        self.groups = expert_groups(cfg)
        tiny = bool(getattr(cfg, "tiny_backbone", False))
        if tiny:
            manager_spec = backbones.TINY
        else:
            manager_spec = backbones.CONV_NET_8G if res == 8 else backbones.CONV_NET_3G
        self.manager = ConvNet(
            manager_spec, 20 * cfg.n_scales, res, (1024, 256, 128), self.n_experts,
            final_activation="relu",  # ReLU before the softmax
        )
        experts = [None] * self.n_experts
        self.slices = [None] * self.n_experts
        for g in self.groups:
            if tiny:
                spec = backbones.TINY
            elif res == 8:
                spec = backbones.expert_backbone_8g(g.first_width)
            else:
                spec = backbones.CONV_NET_3G  # 3^3 experts ignore the divider
            for i, start in zip(g.indices, g.starts):
                experts[i] = ConvNet(
                    spec, g.channels, res, (512, 128, 64), 3
                )
                self.slices[i] = (start, start + g.channels)
        self.experts = torch.nn.ModuleList(experts)
        self.full_state_keys = list(self.state_dict())
        self.full_parameter_names = [n for n, _ in self.named_parameters()]
        self.shard_blocks = None  # [expert rank: its sharded expert ids]
        self.expert_rank = 0
        self.expert_gather = None

    def shard_experts(self, blocks: list, rank: int, gather) -> None:
        """Keep only expert rank `rank`'s experts: `blocks[e]` lists the ids
        expert rank e holds (`train/mesh.py::held_experts`), the ids in
        every block are replicated and the rest sharded.  `gather(x)` takes
        this rank's sharded experts' normals [S, B, 3] to every expert
        rank's, [len(blocks), S, B, 3] (`Mesh.gather_experts`)."""
        common = set.intersection(*map(set, blocks))
        self.shard_blocks = [[i for i in b if i not in common] for b in blocks]
        self.expert_rank = rank
        self.expert_gather = gather
        for i in range(self.n_experts):
            if i not in blocks[rank]:
                self.experts[i] = HeldElsewhere()

    def sharded_parameters(self) -> list:
        if self.shard_blocks is None:
            return []
        return [p for i in self.shard_blocks[self.expert_rank]
                for p in self.experts[i].parameters()]

    def is_shard_key(self, key: str) -> bool:
        return self.shard_blocks is not None and any(
            key.startswith(f"experts.{i}.") for i in self.shard_blocks[self.expert_rank])

    def manager_probs(self, grid: torch.Tensor, training: bool = False,
                      bn_momentum=None) -> torch.Tensor:
        """Manager CNN on a [B, r, r, r, C] grid -> float32 probabilities
        [E, B] (`apply_manager_on_grid`, JAX `experts.py:219-225`)."""
        logits = self.manager(grid.permute(0, 4, 1, 2, 3), training, bn_momentum)  # NCDHW
        return torch.softmax(logits.to(torch.float32), dim=-1).t()

    def expert_on_grid(self, i: int, grid: torch.Tensor, training: bool = False,
                       bn_momentum=None) -> torch.Tensor:
        """Expert `i` on its channel slice of a [b, r, r, r, C] grid ->
        normals [b, 3] (`apply_expert_member_on_grid`, JAX
        `experts.py:227-251`)."""
        lo, hi = self.slices[i]
        x = grid[..., lo:hi].permute(0, 4, 1, 2, 3)
        return self.experts[i](x, training, bn_momentum).to(torch.float32)

    def forward_grid(self, grid: torch.Tensor, training: bool = False,
                     bn_momentum=None) -> dict:
        """Dense MoE on a [B, r, r, r, C] grid -> {"n_pred": [E, B, 3],
        "experts_prob": [E, B]}: every expert on every patch."""
        probs = self.manager_probs(grid, training, bn_momentum)
        if self.shard_blocks is None:
            n_pred = torch.stack([self.expert_on_grid(i, grid, training, bn_momentum)
                                  for i in range(self.n_experts)])
            return {"n_pred": n_pred, "experts_prob": probs}
        out = {i: self.expert_on_grid(i, grid, training, bn_momentum)
               for i in range(self.n_experts) if not isinstance(self.experts[i], HeldElsewhere)}
        parts = self.expert_gather(torch.stack([out[i] for i in
                                                self.shard_blocks[self.expert_rank]]))
        for block, part in zip(self.shard_blocks, parts):
            out.update(zip(block, part))
        return {"n_pred": torch.stack([out[i] for i in range(self.n_experts)]),
                "experts_prob": probs}

    def forward(self, points: torch.Tensor, n_eff: torch.Tensor, training: bool = False,
                bn_momentum=None, dropout_masks=None) -> dict:
        """Dense MoE on a batch of patches; in training every BatchNorm
        normalizes with batch moments and updates its EMA with
        `bn_momentum` (JAX `experts.py:148-175`).  The model has no
        dropout."""
        return self.forward_grid(self.mups_grid(points, n_eff), training, bn_momentum)

    def loss(self, outputs: dict, batch: dict):
        """(scalar loss, {"cos_ang": [E, B]}) against batch["normals"] [B, 3]."""
        loss, cos_ang = moe_loss(outputs["n_pred"], batch["normals"], outputs["experts_prob"],
                                 loss_type=self.cfg.loss_type,
                                 expert_type=self.cfg.expert_loss_type)
        return loss, {"cos_ang": cos_ang}

    @staticmethod
    def predict_normals(outputs: dict) -> torch.Tensor:
        """The argmax expert's normal per patch, [B, 3]."""
        idx = torch.argmax(outputs["experts_prob"], dim=0)
        cols = torch.arange(idx.shape[0], device=idx.device)
        return outputs["n_pred"][idx, cols]

    @staticmethod
    def predict_experts(outputs: dict):
        """(expert id [B], probabilities [B, E]) for the results writers."""
        probs = outputs["experts_prob"]
        return torch.argmax(probs, dim=0), probs.t()
