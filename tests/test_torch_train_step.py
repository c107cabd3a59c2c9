"""The port's train and eval steps against the JAX package's.

A tiny-backbone mixture of experts (3 radii, 3^3 Gaussians, 3 experts in a
single-scale and a three-scale group) is initialized by haiku, its
BatchNorm state randomised, and carried into the port by
`convert.from_haiku`.  The same seeded numpy batch then goes through
JAX's jitted `make_train_step` and the port's, for adam and momentum, each
with weight_decay 0 and 1e-4, at a learning rate of 1e-3 and a decay step
that moves both schedules down one stair at step 2.  After one and after
three steps the loss, the parameters, the BatchNorm state and the
optimizer moments are compared (converted by `convert.optimizer_state_from_optax`).

Tolerances, stated per quantity:
  * loss: rtol 1e-5 after step 1, 1e-4 after step 3 (float32 forward
    passes; the trajectories have moved apart by then);
  * momentum (linear in the gradient): every parameter atol 5e-5 + rtol
    1e-4, every trace atol 5e-3 + rtol 1e-3 (a trace sums the gradients,
    which agree to about 1e-5 relative);
  * adam: a conv or linear bias that feeds a train-mode BatchNorm has an
    exact gradient of 0 (the BatchNorm subtracts the batch mean) and a
    numerical one of rounding noise near 1e-9; adam's first update,
    lr g / (|g| + 1e-8), scales that noise to nearly +-lr, with its own sign
    in each package.  The same holds for a kernel element whose input is
    the same on every patch.  Those biases, and the EMA means of the
    BatchNorms behind them, are held at atol 2 lr steps; of any other
    tensor at most 0.1% of the elements may take that bound, the rest hold
    atol 1e-5 + rtol 1e-4 after one step and atol 5e-5 + rtol 1e-3 after
    three; the moments mu and nu at atol 1e-5 + rtol 1e-3 (mu of a noise
    element is 0.1 times noise; measured at most 1.3e-6 off, on mu of
    0.02);
  * the EMA variances and the debias `bias`: atol 1e-5, rtol 1e-3 (the
    noise elements of adam's kernels move the batch variances behind them
    by up to 2e-4 relative; momentum measures 1e-6).
The eval step (EMA statistics, argmax expert's cosine) agrees at atol 1e-5
on the converted weights, and one bfloat16 momentum step agrees with eager
JAX in bfloat16 within the bounds stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.core.config import Config as JaxConfig
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu.train import train_step as jts
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.models import build_model
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.gmm import GridGMM
from nestinet_tpu_torch.train import train_step as tts

from .test_torch_experts import random_bn
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

N_POINT = 12
BATCH = 8
LR = 1e-3
STEPS = 3
EXPERTS = {0: [0], 1: [1], 2: [0, 1, 2]}


def cfgs(**kw):
    base = dict(model="experts_n_est", tiny_backbone=True, num_point=N_POINT,
                num_gaussians=3, gmm_variance=1.0 / 9, patch_radius=(0.01, 0.03, 0.05),
                n_experts=3, expert_dict=EXPERTS, batch_size=BATCH, learning_rate=LR,
                decay_step=2 * BATCH, decay_rate=0.7)
    base.update(kw)
    return Config(**base), JaxConfig(**base)


def make_batch(seed):
    rng = np.random.RandomState(seed)
    points = rng.uniform(-1, 1, size=(BATCH, 3 * N_POINT, 3)).astype(np.float32)
    n_eff = rng.randint(1, N_POINT + 1, size=(BATCH, 3)).astype(np.int32)
    n_eff[-1, 0] = 0  # one zero-padded radius
    for b in range(BATCH):
        for s in range(3):
            points[b, s * N_POINT + n_eff[b, s] + 1:(s + 1) * N_POINT] = 0.0
    normals = rng.normal(size=(BATCH, 3)).astype(np.float32)
    return {"points": points, "n_eff": n_eff, "normals": normals}


@pytest.fixture(scope="module")
def start():
    """Seeded haiku params with random BatchNorm state, and the batch."""
    _, jcfg = cfgs()
    gmm = get_3d_grid_gmm([3, 3, 3], variance=jcfg.gmm_variance)
    batch = make_batch(11)
    jm = jax_build_model(jcfg, gmm)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(5), batch)
    params, state = random_bn(params, state, np.random.RandomState(12))
    return gmm, batch, params, state


def port_model(cfg, gmm, params, state):
    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    return model


def bn_fed_biases(model) -> set:
    """Names of the biases that feed a train-mode BatchNorm."""
    out = set()
    for name, m in model.named_modules():
        if isinstance(m, tnn.ConvBN3D):
            out.add(f"{name}.conv.b")
        elif isinstance(m, tnn.DenseBN) and m.bn is not None:
            out.add(f"{name}.linear.b")
    return out


def run_jax(jcfg, gmm, params, state, batch, steps):
    jm = jax_build_model(jcfg, gmm)
    tx = jts.make_optimizer(jcfg)
    step_fn = jax.jit(jts.make_train_step(jm, jcfg, tx))
    p, s, o = params, state, tx.init(params)
    out = []
    for i in range(steps):
        p, s, o, loss = step_fn(p, s, o, None, batch, jnp.asarray(i, jnp.int32))
        out.append((float(loss), jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), o))
    return out


def assert_noise_tolerant(name, got, want, atol, rtol, noise_bound, max_frac):
    """Elementwise within atol + rtol |want|, but for at most `max_frac`
    of the elements, which stay within `noise_bound`."""
    got, want = got.numpy(), want.numpy()
    diff = np.abs(got - want)
    off = diff > atol + rtol * np.abs(want)
    assert off.mean() <= max_frac, (name, off.mean(), diff.max())
    assert (diff <= noise_bound).all(), (name, diff.max(), noise_bound)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_train_steps_match_jax(start, optimizer, weight_decay):
    gmm, batch, params, state = start
    cfg, jcfg = cfgs(optimizer=optimizer, weight_decay=weight_decay)
    want = run_jax(jcfg, gmm, params, state, batch, STEPS)

    model = port_model(cfg, gmm, params, state)
    opt = tts.make_optimizer(model, cfg)
    assert isinstance(opt, torch.optim.Adam if optimizer == "adam" else torch.optim.SGD)
    step_fn = tts.make_train_step(model, cfg, opt)
    noisy = bn_fed_biases(model)
    names = [n for n, _ in model.named_parameters()]
    for i in range(STEPS):
        loss = step_fn(batch, i)
        if i not in (0, STEPS - 1):
            continue
        w_loss, w_params, w_state, w_opt = want[i]
        steps = i + 1
        np.testing.assert_allclose(loss.item(), w_loss, rtol=1e-5 if steps == 1 else 1e-4)
        ref = convert.from_haiku(w_params, w_state, cfg)
        sd = model.state_dict()
        assert set(sd) == set(ref)
        bound = 2 * LR * steps
        for key, value in sd.items():
            leaf = key.rsplit(".", 1)[-1]
            # every BatchNorm's batch mean carries the bias in front of it
            feeds_noise = key in noisy or leaf == "ema_mean"
            if leaf in ("ema_var", "bias"):
                torch.testing.assert_close(value, ref[key], atol=1e-5, rtol=1e-3, msg=key)
            elif optimizer == "momentum" and leaf != "ema_mean":
                torch.testing.assert_close(value, ref[key], atol=5e-5, rtol=1e-4, msg=key)
            elif feeds_noise:
                torch.testing.assert_close(value, ref[key], atol=bound, rtol=0, msg=key)
            else:
                tol = (1e-5, 1e-4) if steps == 1 else (5e-5, 1e-3)
                assert_noise_tolerant(key, value, ref[key], *tol, bound, 1e-3)
        moments = convert.optimizer_state_from_optax(w_opt, model, cfg)
        for idx, name in enumerate(names):
            got = opt.state[dict(model.named_parameters())[name]]
            if optimizer == "adam":
                assert got["step"].item() == steps == int(w_opt[0].count)
                for k in ("exp_avg", "exp_avg_sq"):
                    torch.testing.assert_close(got[k], moments[idx][k], atol=1e-5, rtol=1e-3,
                                               msg=f"{name} {k}")
            else:
                torch.testing.assert_close(got["momentum_buffer"],
                                           moments[idx]["momentum_buffer"], atol=5e-3,
                                           rtol=1e-3, msg=name)


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_optimizer_state_round_trips_through_optax(start, optimizer):
    """optax state -> torch optimizer -> optax trees, bit for bit; a torch
    optimizer loaded with the converted state takes the same next update
    as the one that made it."""
    gmm, batch, params, state = start
    cfg, jcfg = cfgs(optimizer=optimizer)
    w_opt = run_jax(jcfg, gmm, params, state, batch, 2)[-1][3]
    model = port_model(cfg, gmm, params, state)
    opt = tts.make_optimizer(model, cfg)
    sd = opt.state_dict()
    sd["state"] = convert.optimizer_state_from_optax(w_opt, model, cfg)
    opt.load_state_dict(sd)
    back = convert.optimizer_state_to_optax(opt, model, cfg)
    inner = w_opt[0]
    keys = ("mu", "nu") if optimizer == "adam" else ("trace",)
    if optimizer == "adam":
        assert back["count"] == int(inner.count) == 2
    for key in keys:
        want = jax.tree.map(np.asarray, getattr(inner, key))
        got = back[key]
        assert set(got) == set(want)
        for top in want:
            for path, leaves in want[top].items():
                for leaf, v in leaves.items():
                    np.testing.assert_array_equal(got[top][path][leaf], v, err_msg=f"{top}/{path}")


def test_eval_step_matches_jax(start):
    gmm, batch, params, state = start
    cfg, jcfg = cfgs()
    jm = jax_build_model(jcfg, gmm)
    w_loss, w_cos = jax.jit(jts.make_eval_step(jm, jcfg))(params, state, batch)
    model = port_model(cfg, gmm, params, state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, cos = tts.make_eval_step(model)(batch)
    assert cos.shape == (BATCH,)
    np.testing.assert_allclose(loss.item(), float(w_loss), atol=1e-5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(w_cos), atol=1e-5)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)  # eval changes nothing


def test_bfloat16_step_matches_eager_jax(start):
    """One momentum step in bfloat16 against eager JAX (one op at a time,
    as the port; the MoE cut to its manager and one three-scale expert,
    because eager JAX dispatches every op of the step one by one):
    parameters float32, the grid cast once, every op in bfloat16, the BN
    moments in float32.  The convolutions round their bfloat16 outputs
    apart now and then, and train-mode BatchNorm scales those ulps (see
    test_torch_nn_train.py).  Bars: the loss at rtol 1e-3 (measured:
    equal); each parameter's update (new - old = -lr g) within a relative
    L2 error of 0.05 of JAX's (measured: at most 0.018), but for the BN-fed
    biases, whose update is rounding noise, which stay within 2 lr of JAX's;
    the EMA state at atol 5e-3 + rtol 2e-2."""
    gmm, batch, _, _ = start
    cfg, jcfg = cfgs(optimizer="momentum", compute_dtype="bfloat16", n_experts=1,
                     expert_dict={0: [0, 1, 2]})
    jm = jax_build_model(jcfg, gmm)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(6), batch)
    params, state = random_bn(params, state, np.random.RandomState(13))
    tx = jts.make_optimizer(jcfg)
    p1, s1, _, w_loss = jts.make_train_step(jm, jcfg, tx)(  # eager: one op at a time
        params, state, tx.init(params), None, batch, jnp.asarray(0, jnp.int32))
    model = port_model(cfg, gmm, params, state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = tts.make_train_step(model, cfg, tts.make_optimizer(model, cfg))(batch, 0)
    assert model.mups_grid(torch.from_numpy(batch["points"]),
                           torch.from_numpy(batch["n_eff"])).dtype == torch.bfloat16
    np.testing.assert_allclose(loss.item(), float(w_loss), rtol=1e-3)
    ref = convert.from_haiku(jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, s1), cfg)
    noisy = bn_fed_biases(model)
    for key, value in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("ema_mean", "ema_var", "bias"):
            torch.testing.assert_close(value, ref[key], atol=5e-3, rtol=2e-2, msg=key)
            continue
        got, want = value - before[key], ref[key] - before[key]
        if key in noisy:
            assert (got - want).abs().max() <= 2 * LR, key
        else:
            assert torch.linalg.norm(got - want) <= 0.05 * torch.linalg.norm(want) + 1e-9, key


def test_train_step_runs_the_mups_forward_once_and_no_backward(start, monkeypatch):
    """The points are constants of the loss (JAX differentiates with
    respect to the parameters only): one statistics call per step, and the
    MuPS backward never runs."""
    from nestinet_tpu_torch.ops import mups as mups_ops

    gmm, batch, params, state = start
    cfg, _ = cfgs()
    model = port_model(cfg, gmm, params, state)
    calls = []
    real = mups_ops.tdmfv_n_est_reference
    monkeypatch.setattr(mups_ops, "tdmfv_n_est_reference",
                        lambda *a: calls.append(1) or real(*a))
    mups_ops.BACKWARD_CALLS["plain"] = 0
    tts.make_train_step(model, cfg, tts.make_optimizer(model, cfg))(batch, 0)
    tts.make_eval_step(model)(batch)
    assert len(calls) == 2
    assert mups_ops.BACKWARD_CALLS["plain"] == 0
