"""The port's train step on the ablation models against the JAX package's.

Narrow single-scale, multi-scale and switching models (both packages'
backbones replaced by `TINY`, as in `tests/test_torch_ablations.py`) are
initialized by haiku with random BatchNorm state and carried into the port.
The same seeded batch (normals and, for switching, noise levels as targets)
then goes through JAX's `make_train_step` and the port's with adam, and
after one and after three steps the loss, the parameters, the BatchNorm
state and adam's moments are held at the bars of
`tests/test_torch_train_step.py` (`check_step`).

The switching model has no dropout, and JAX's step runs jitted.  The
single- and multi-scale heads drop at rate 0.3: JAX's step runs eagerly
with its per-step key `fold_in(PRNGKey(seed + 1), step)` (as its trainer
draws it) and a recording copy of its dropout, which draws each keep mask
as `hk.dropout` does (`tests/test_torch_ablations.py` pins that formula to
hk.dropout bit for bit); the port's step replays those masks through its
`dropout_masks`.

With dropout the two trajectories part faster.  The cause, traced on the
multi-scale model: after step 1 two elements of `fc1`'s kernel are apart
by up to 3.8e-4, because their step-1 gradients are rounding residues
near adam's eps (1.3e-8 in JAX, 1.7e-7 in the port), which adam's
lr g / (|g| + 1e-8) turns into different fractions of lr; the weights'
noise rule holds them.  That difference alone (swapping just that kernel
into JAX's state) flips the sign of step 2's gradient of `fc2`'s kernel
element [50, 142], a true near-zero by cancellation (x . dy over the
batch, terms of 5e-3 that sum to -4.5e-7 on JAX's state in float32 and in
float64, and to +6.6e-7 on the port's), so adam moves it by +-0.74 lr and
it ends step 2 1.45e-3 apart.  At step 3 that kernel moves the gradients
around it: adam's first moment of 4 of the model's 994,902 moment
elements is off the elementwise bar, by at most 3.7e-5 (in a 32-element
conv kernel of `incep0`).  From JAX's state after step 2 the port's
step-3 gradient of the worst `fc3` element equals JAX's to seven digits,
and swapping in only the port's `fc2` kernel moves it by 1.5e-4, ten
times its first-moment gap.  So after three free-running steps adam's
moments of the two dropout models hold atol 1e-5 + rtol 1e-3 for all but
1e-5 of the model's moment elements (9 in the multi-scale model, 4
measured), which stay within 1e-4; the single-scale model has none off.
And at every step, after one step that starts from JAX's previous state
(weights, BatchNorm state, moments), every moment element holds the
elementwise bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nestinet_tpu.models.base as jax_base
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.train import train_step as jts
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.train import train_step as tts

from .test_torch_ablations import ABLATIONS, make_case, narrow_backbones, port_model
from .test_torch_train_step import assert_noise_tolerant, bn_fed_biases
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3
SEED = 7
MOMENT_NOISE = 1e-4
MOMENT_NOISE_FRAC = 1e-5


class RecordingDropout:
    """JAX's `ops.nn.dropout` as `fc_head` calls it, drawing each mask as
    hk.dropout does and keeping it (eager JAX: the masks are concrete)."""

    def __init__(self):
        self.masks = []

    def __call__(self, x, rate, is_training):
        import haiku as hk

        if not is_training or rate == 0.0:
            return x
        keep_rate = 1.0 - rate
        keep = jax.random.bernoulli(hk.next_rng_key(), keep_rate, shape=x.shape)
        self.masks.append(np.array(keep))
        return keep * x / keep_rate


def run_jax(model, jcfg, gmm, params, state, batch, monkeypatch):
    """STEPS JAX train steps; [(loss, params, state, opt_state, masks)]."""
    jm = jax_build_model(jcfg, gmm)
    tx = jts.make_optimizer(jcfg)
    dropout = model != "ms_sw_n_est"
    step_fn = jts.make_train_step(jm, jcfg, tx)
    if dropout:
        recorder = RecordingDropout()
        monkeypatch.setattr(jax_base, "dropout", recorder)
    else:
        step_fn = jax.jit(step_fn)
    base_key = jax.random.PRNGKey(jcfg.seed + 1)
    p, s, o = params, state, tx.init(params)
    out = []
    for i in range(STEPS):
        n_masks = len(recorder.masks) if dropout else 0
        rng = jax.random.fold_in(base_key, i) if dropout else None
        p, s, o, loss = step_fn(p, s, o, rng, batch, jnp.asarray(i, jnp.int32))
        masks = recorder.masks[n_masks:] if dropout else None
        out.append((float(loss), jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s),
                    o, masks))
    return out


def check_step(model, cfg, opt, want, steps, noisy, noise_frac=0.0):
    """The bars of `tests/test_torch_train_step.py` for adam after
    `steps` steps; `noise_frac` as in `check_moments`."""
    w_loss, w_params, w_state, w_opt, _ = want
    ref = convert.from_haiku(w_params, w_state, cfg)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    bound = 2 * LR * steps
    for key, value in sd.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("ema_var", "bias"):
            torch.testing.assert_close(value, ref[key], atol=1e-5, rtol=1e-3, msg=key)
        elif key in noisy or leaf == "ema_mean":
            torch.testing.assert_close(value, ref[key], atol=bound, rtol=0, msg=key)
        else:
            tol = (1e-5, 1e-4) if steps == 1 else (5e-5, 1e-3)
            assert_noise_tolerant(key, value, ref[key], *tol, bound, 1e-3)
    check_moments(model, cfg, opt, w_opt, steps, noise_frac)


def check_moments(model, cfg, opt, w_opt, steps, noise_frac=0.0):
    """adam's moments at atol 1e-5 + rtol 1e-3, but for at most
    `noise_frac` of all the model's moment elements, which stay within
    MOMENT_NOISE."""
    moments = convert.optimizer_state_from_optax(w_opt, model, cfg)
    n_off = n_all = 0
    for idx, (name, param) in enumerate(model.named_parameters()):
        got = opt.state[param]
        assert got["step"].item() == steps == int(w_opt[0].count)
        for k in ("exp_avg", "exp_avg_sq"):
            diff = (got[k] - moments[idx][k]).abs()
            off = diff > 1e-5 + 1e-3 * moments[idx][k].abs()
            n_off, n_all = n_off + int(off.sum()), n_all + off.numel()
            if noise_frac > 0.0:
                assert diff.max() <= MOMENT_NOISE, (name, k, diff.max().item())
            else:
                torch.testing.assert_close(got[k], moments[idx][k], atol=1e-5, rtol=1e-3,
                                           msg=lambda m, name=name, k=k: f"{name} {k}: {m}")
    assert n_off <= noise_frac * n_all, (n_off, n_all)


@pytest.mark.parametrize("model", sorted(ABLATIONS))
def test_train_steps_match_jax(model, monkeypatch):
    with narrow_backbones():
        cfg, jcfg, gmm, params, state, batch = make_case(
            model, seed=SEED, learning_rate=LR, decay_step=16, decay_rate=0.7, spread=0.01)
        want = run_jax(model, jcfg, gmm, params, state, batch, monkeypatch)
        ported = port_model(cfg, gmm, params, state).train()
    opt = tts.make_optimizer(ported, cfg)
    metrics = {}
    step_fn = tts.make_train_step(ported, cfg, opt, metrics)
    noisy = bn_fed_biases(ported)
    for i in range(STEPS):
        masks = want[i][4]
        if masks is not None:
            assert len(masks) == 3  # fc1, fc2 and fc3 drop
            masks = tnn.Dropout(masks=[torch.from_numpy(m) for m in masks])
        loss = step_fn(batch, i, masks)
        np.testing.assert_allclose(loss.item(), want[i][0], rtol=1e-5 if i == 0 else 1e-4)
        if i in (0, STEPS - 1):
            dropout_noise = want[i][4] is not None and i > 0
            check_step(ported, cfg, opt, want[i], i + 1, noisy,
                       MOMENT_NOISE_FRAC if dropout_noise else 0.0)
    if model == "ms_sw_n_est":
        assert len(metrics["noise_loss"]) == STEPS
        assert all(0 < float(v) < want[0][0] for v in metrics["noise_loss"])
        return
    assert metrics == {}
    # adam's update at every step, each from JAX's state after the step before
    for i in range(1, STEPS):
        _, w_params, w_state, w_opt, _ = want[i - 1]
        with narrow_backbones():
            forced = port_model(cfg, gmm, w_params, w_state).train()
        opt = tts.make_optimizer(forced, cfg)
        sd = opt.state_dict()
        sd["state"] = convert.optimizer_state_from_optax(w_opt, forced, cfg)
        opt.load_state_dict(sd)
        tts.make_train_step(forced, cfg, opt)(
            batch, i, tnn.Dropout(masks=[torch.from_numpy(m) for m in want[i][4]]))
        check_moments(forced, cfg, opt, want[i][3], i + 1)


@pytest.mark.parametrize("model", ["ss_norm_est", "ms_norm_est"])
def test_step_dropout_is_seeded_by_step(model):
    """Without masks the step draws from (seed + 1, step): the same step
    gives the same masks (a resumed run draws what the unbroken run drew),
    another step others."""
    with narrow_backbones():
        cfg, _, gmm, params, state, batch = make_case(model, seed=SEED)
        outs = []
        for step in (4, 4, 5):
            m = port_model(cfg, gmm, params, state).train()
            masks = tts.step_dropout(cfg, step, torch.device("cpu"))
            with torch.no_grad():
                outs.append(m(torch.from_numpy(batch["points"]), torch.from_numpy(batch["n_eff"]),
                              True, 0.5, masks)["n_pred"])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_eval_step_on_the_ablations_matches_jax():
    """The eval step's loss and per-sample cosine (no argmax: one
    prediction per patch) on converted weights, atol 1e-5."""
    for model in sorted(ABLATIONS):
        with narrow_backbones():
            cfg, jcfg, gmm, params, state, batch = make_case(model, seed=SEED)
            jm = jax_build_model(jcfg, gmm)
            w_loss, w_cos = jax.jit(jts.make_eval_step(jm, jcfg))(params, state, batch)
            loss, cos = tts.make_eval_step(port_model(cfg, gmm, params, state))(batch)
        np.testing.assert_allclose(loss.item(), float(w_loss), atol=1e-5)
        np.testing.assert_allclose(cos.numpy(), np.asarray(w_cos), atol=1e-5)
        assert cos.shape == (batch["points"].shape[0],)
