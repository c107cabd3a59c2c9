"""Learning-rate and BN-decay schedules.

Counterpart of `nestinet_tpu/train/schedules.py` (`:17-44`), parity with
the reference (`train_n_est_w_experts.py:143-162`):
  * lr: staircase exponential decay on EXAMPLES SEEN (step * batch_size),
    floored at `lr_min` (`train_n_est.py:120-128`);
  * bn decay: bn_momentum decays 0.5 -> 0 with the same staircase, and
    the EMA decay used is min(0.99, 1 - bn_momentum), i.e. it GROWS
    0.5 -> 0.99 over training.
Both are computed in float32, as JAX computes them in the compiled step,
and returned as numpy float32 scalars.
"""

from __future__ import annotations

import numpy as np


def _staircase(step, base: float, rate: float, decay_step: int, batch: int) -> np.float32:
    examples = np.float32(step) * np.float32(batch)
    return np.float32(base) * np.power(np.float32(rate),
                                       np.floor(examples / np.float32(decay_step)))


def learning_rate_schedule(cfg):
    def schedule(step) -> np.float32:
        lr = _staircase(step, cfg.learning_rate, cfg.decay_rate, cfg.decay_step, cfg.batch_size)
        return np.maximum(lr, np.float32(cfg.lr_min))

    return schedule


def bn_momentum_schedule(cfg):
    def schedule(step) -> np.float32:
        momentum = _staircase(step, cfg.bn_init_decay, cfg.bn_decay_rate, cfg.decay_step,
                              cfg.batch_size)
        return np.minimum(np.float32(cfg.bn_decay_clip), np.float32(1.0) - momentum)

    return schedule
