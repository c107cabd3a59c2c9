"""The port's losses and schedules against the JAX package's.

Losses: the same seeded numpy predictions, normals and probabilities go
through `nestinet_tpu.models.losses` and `nestinet_tpu_torch.models.losses`;
values and gradients (with respect to the predictions and the
probabilities) agree at float32 tolerance, atol 1e-6 and rtol 1e-5 (the
two packages reduce in other orders).  Rows of zeros stand for a zero
prediction: its gradient stays finite in both.

Schedules: the learning rate and the BN decay at steps around a staircase
boundary and at the lr floor; the port computes them in float32 as JAX
does, so they agree to one float32 ulp (rtol 2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.core.config import Config
from nestinet_tpu.models import losses as jlosses
from nestinet_tpu.train import schedules as jsched
from nestinet_tpu_torch.models import losses
from nestinet_tpu_torch.train import schedules

TOL = dict(atol=1e-6, rtol=1e-5)
LOSS_TYPES = ("cos", "euclidean", "sin")


def _inputs(seed, E=4, B=9):
    rng = np.random.RandomState(seed)
    n_pred = rng.normal(size=(E, B, 3)).astype(np.float32)
    n_pred[1, 2] = 0.0  # a zero prediction
    n_pred[2, 4] = 0.0
    n_gt = rng.normal(size=(B, 3)).astype(np.float32)
    n_pred[0, 5] = -3.0 * n_gt[5]  # an exact flip: diff at its minimum
    logits = rng.normal(size=(E, B)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(0)
    return n_pred, n_gt, probs.astype(np.float32)


@pytest.mark.parametrize("expert_type", ["simple", "gaussian"])
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_moe_loss_values_and_gradients_match_jax(loss_type, expert_type):
    n_pred, n_gt, probs = _inputs(1)

    def jfn(p, q):
        return jlosses.moe_loss(p, jnp.asarray(n_gt), q, loss_type, expert_type)

    (want, want_cos), (gp, gq) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(n_pred), jnp.asarray(probs))
    p = torch.from_numpy(n_pred).requires_grad_(True)
    q = torch.from_numpy(probs).requires_grad_(True)
    got, got_cos = losses.moe_loss(p, torch.from_numpy(n_gt), q, loss_type, expert_type)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_cos.detach().numpy(), np.asarray(want_cos), **TOL)
    assert torch.isfinite(p.grad).all() and torch.isfinite(q.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **TOL)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(gq), **TOL)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_normal_loss_values_and_gradients_match_jax(loss_type):
    n_pred, n_gt, _ = _inputs(2)
    n_pred = n_pred[1]  # holds a zero row

    def jfn(p):
        return jlosses.normal_loss(p, jnp.asarray(n_gt), loss_type)

    (want, want_cos), gp = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(n_pred))
    p = torch.from_numpy(n_pred).requires_grad_(True)
    got, got_cos = losses.normal_loss(p, torch.from_numpy(n_gt), loss_type)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_cos.detach().numpy(), np.asarray(want_cos), **TOL)
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **TOL)


def test_safe_normalize_of_zero_is_zero_with_a_finite_gradient():
    v = torch.zeros((2, 3), requires_grad=True)
    out = losses.safe_normalize(v)
    out.sum().backward()
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isfinite(v.grad).all()


@pytest.mark.parametrize("bad", [dict(loss_type="l1"), dict(expert_type="max")])
def test_unknown_loss_types_raise(bad):
    n_pred, n_gt, probs = (torch.from_numpy(a) for a in _inputs(3))
    with pytest.raises(ValueError):
        losses.moe_loss(n_pred, n_gt, probs, **bad)


def _schedule_cfg(**kw):
    base = dict(batch_size=64, decay_step=1000, learning_rate=1e-3, decay_rate=0.7,
                lr_min=1e-6, bn_init_decay=0.5, bn_decay_rate=0.5, bn_decay_clip=0.99)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("name", ["learning_rate_schedule", "bn_momentum_schedule"])
def test_schedules_match_jax_across_a_staircase_and_the_floor(name):
    cfg = _schedule_cfg()
    # 1000 examples per stair at 64 a step: the boundary falls inside
    # step 15 -> 16 (960 -> 1024 examples); steps past 1,200 hold the
    # lr at its floor (0.7^77 * 1e-3 < 1e-6) and the BN decay at its clip.
    steps = [0, 1, 15, 16, 17, 31, 32, 300, 1200, 5000]
    ours, theirs = getattr(schedules, name)(cfg), getattr(jsched, name)(cfg)
    got = np.array([ours(s) for s in steps])
    want = np.array([float(theirs(s)) for s in steps], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert got[3] != got[2] and got[2] == got[1]  # one stair down at step 16


def test_learning_rate_floor_and_bn_clip():
    cfg = _schedule_cfg()
    lr, bn = schedules.learning_rate_schedule(cfg), schedules.bn_momentum_schedule(cfg)
    assert lr(0) == np.float32(1e-3)
    assert lr(10 ** 6) == np.float32(cfg.lr_min)
    assert bn(0) == np.float32(0.5)
    assert bn(10 ** 6) == np.float32(0.99)
