"""Training and evaluation steps.

Counterpart of `nestinet_tpu/train/train_step.py` (`:28-34`, `:71-119`).
JAX compiles one program per step and computes the schedules in it; here a
step is eager PyTorch on the model's device, and the schedules are read on
the host before it.  The XLA and TPU-mesh machinery (`_startup_barrier`,
`jit_*`, `place_train_state`) has no counterpart.

The optimizers compute optax's updates:
  * `adam`: optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    eps_root 0) is torch.optim.Adam;
  * `momentum`: optax.sgd(momentum=m), the trace t = g + m t and the update
    -lr t, is torch.optim.SGD(momentum=m, dampening=0, nesterov=False).
The learning rate is set on every parameter group before each update, from
the schedule at the number of updates taken so far, as optax reads it.

Dropout (the single- and multi-scale models) draws its masks from a
generator seeded by (cfg.seed + 1, step), as JAX folds the step into
PRNGKey(seed + 1) (`train/trainer.py:160-179`): a resumed run draws what
the unbroken run drew.  The streams differ from JAX's; a test passes JAX's
masks in through `dropout_masks`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.nn import Dropout, l2_weight_penalty
from .schedules import bn_momentum_schedule, learning_rate_schedule


def make_optimizer(model: torch.nn.Module, cfg) -> torch.optim.Optimizer:
    lr = float(learning_rate_schedule(cfg)(0))
    if cfg.optimizer == "adam":
        return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(model.parameters(), lr=lr, momentum=cfg.momentum,
                               dampening=0.0, nesterov=False)
    raise ValueError(f"unknown optimizer: {cfg.optimizer}")


def _device_batch(model, batch: dict) -> dict:
    """The batch's arrays as tensors on the model's device."""
    dev = model.gmm_w.device
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def step_dropout(cfg, step: int, device, shard: tuple[int, slice] | None = None) -> Dropout:
    """The dropout masks of train step `step`: a generator on `device`
    seeded by (cfg.seed + 1, step); a data-parallel rank passes `shard`
    (global batch, its rows) and keeps its rows of the global masks."""
    seed = int(np.random.SeedSequence([cfg.seed + 1, step]).generate_state(1)[0])
    return Dropout(torch.Generator(device=device).manual_seed(seed), shard=shard)


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer, metrics: dict | None = None,
                    mesh=None):
    """Returns train_step(batch, step, dropout_masks=None) -> the loss (a
    0-d tensor on the device, not synchronized).  `batch` holds points,
    n_eff, normals and, for the switching model, noise; `step` is the
    number of updates taken so far, which sets the scheduled BN momentum,
    the learning rate and the dropout masks (`step_dropout`, unless
    `dropout_masks` is given).  The step updates the parameters and the
    BatchNorm state in place and leaves the gradients in `.grad`.  With
    `metrics`, each step appends its scalar metrics other than the loss
    (the switching model's noise_loss), detached, to metrics[name].

    With a data mesh (`train/mesh.py`) in a process group, `batch` is this
    rank's rows of the global batch and the step is the global batch's, as
    JAX's sharded step is: BatchNorm takes the global moments (the caller
    gives the model the mesh's sum, `ops/nn.py::set_moment_sum`), dropout
    keeps this rank's rows of the global masks, and the gradients, the loss
    and the metrics are averaged over the ranks in one flat all-reduce
    before the update.  The ranks hold equal rows, so the average of their
    mean losses is the global batch's mean loss; `l2_weight_penalty`, the
    same on every rank, is averaged to itself and counts once.  One flat
    all-reduce rather than DDP: the step stays the single-process step plus
    one collective, bit for bit that step on a world of one, and the loss
    and the metrics ride in the same buffer; DDP's bucketed all-reduce
    would overlap the backward on several GPUs, which this card does not
    have to measure.

    On an expert axis (`train/mesh.py`) the ranks of one expert group take
    the same rows and the model holds this rank's expert shard only
    (`models/experts.py`): the shard's gradients are averaged over the data
    group, the replicated ones over the world, and the logged loss counts
    the weight penalty of every shard once."""
    bn_sched = bn_momentum_schedule(cfg)
    lr_sched = learning_rate_schedule(cfg)
    parallel = mesh is not None and mesh.parallel
    sharded = model.sharded_parameters()

    def train_step(batch: dict, step: int, dropout_masks: Dropout | None = None) -> torch.Tensor:
        batch = _device_batch(model, batch)
        lr = float(lr_sched(step))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        if dropout_masks is None:
            rows = batch["points"].shape[0]
            shard = (rows * mesh.size, mesh.rows(rows * mesh.size)) if parallel else None
            dropout_masks = step_dropout(cfg, step, batch["points"].device, shard)
        outputs = model(batch["points"], batch["n_eff"], training=True,
                        bn_momentum=bn_sched(step), dropout_masks=dropout_masks)
        loss, aux = model.loss(outputs, batch)
        logged = None
        if cfg.weight_decay > 0.0:
            loss = loss + cfg.weight_decay * l2_weight_penalty(model)
            if sharded:  # this rank's penalty counts its own shard only
                shard = l2_weight_penalty(model, sharded).detach()
                logged = loss.detach() + cfg.weight_decay * (mesh.expert_sum_(shard.clone())
                                                             - shard)
        loss.backward()
        scalars = {"loss": loss.detach() if logged is None else logged,
                   **{k: v.detach() for k, v in aux.items() if k != "cos_ang"}}
        if parallel:
            scalars = mesh.mean_gradients_(model.parameters(), scalars, sharded)
        optimizer.step()
        if metrics is not None:
            for name, value in scalars.items():
                if name != "loss":
                    metrics.setdefault(name, []).append(value)
        return scalars["loss"]

    return train_step


def make_eval_step(model):
    """Returns eval_step(batch) -> (loss, cos_ang [B]): the model in
    inference mode (EMA BatchNorm statistics), the validation loss and each
    sample's cosine, for the mixture of experts its argmax expert's (JAX
    `train_step.py:103-117`)."""

    @torch.no_grad()
    def eval_step(batch: dict):
        batch = _device_batch(model, batch)
        outputs = model(batch["points"], batch["n_eff"])
        loss, aux = model.loss(outputs, batch)
        cos_ang = aux["cos_ang"]
        if cos_ang.dim() == 2:  # the mixture of experts: [E, B]
            idx = torch.argmax(outputs["experts_prob"], dim=0)
            cos_ang = cos_ang.gather(0, idx[None])[0]
        return loss, cos_ang

    return eval_step
