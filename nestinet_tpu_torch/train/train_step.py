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
"""

from __future__ import annotations

import torch

from ..ops.nn import l2_weight_penalty
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


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer):
    """Returns train_step(batch, step) -> the loss (a 0-d tensor on the
    device, not synchronized).  `batch` holds points, n_eff and normals;
    `step` is the number of updates taken so far, which sets the scheduled
    BN momentum and learning rate.  The step updates the parameters and
    the BatchNorm state in place and leaves the gradients in `.grad`."""
    bn_sched = bn_momentum_schedule(cfg)
    lr_sched = learning_rate_schedule(cfg)

    def train_step(batch: dict, step: int) -> torch.Tensor:
        batch = _device_batch(model, batch)
        lr = float(lr_sched(step))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        outputs = model(batch["points"], batch["n_eff"], training=True,
                        bn_momentum=bn_sched(step))
        loss, _ = model.loss(outputs, batch["normals"])
        if cfg.weight_decay > 0.0:
            loss = loss + cfg.weight_decay * l2_weight_penalty(model)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(model):
    """Returns eval_step(batch) -> (loss, cos_ang [B]): the model in
    inference mode (EMA BatchNorm statistics), the validation loss and the
    cosine of each sample's argmax expert (JAX `train_step.py:110-117`)."""

    @torch.no_grad()
    def eval_step(batch: dict):
        batch = _device_batch(model, batch)
        outputs = model(batch["points"], batch["n_eff"])
        loss, cos_ang = model.loss(outputs, batch["normals"])
        idx = torch.argmax(outputs["experts_prob"], dim=0)
        return loss, cos_ang.gather(0, idx[None])[0]

    return eval_step
