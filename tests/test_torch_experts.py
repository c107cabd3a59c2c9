"""The port's mixture of experts against the JAX `ExpertsNormEst`.

A tiny-backbone JAX init (8^3 grid, 3 scales, 7 experts in two groups) is
carried into the port by `convert.from_haiku`; the converter must
round-trip it bit-exactly, and dense inference on the same numpy batch
must agree: n_pred and experts_prob within atol 1e-4 (float32, different
conv summation orders), argmax expert ids identical.
"""

import jax
import numpy as np
import pytest
import torch

from nestinet_tpu.core.config import Config
from nestinet_tpu.models import backbones as jax_backbones
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.models import backbones
from nestinet_tpu_torch.models import build_model
from nestinet_tpu_torch.ops.gmm import GridGMM
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

N_POINT = 16


def random_bn(params, state, rng):
    """Random BN affine and EMA state (ema_var > 0, bias in (0.1, 0.9)) on
    a haiku tree of any nesting, stacked group axes included, so the
    debiasing is exercised and activations stay O(1)."""
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    for tree in params.values():
        for leaves in tree.values():
            if "gamma" in leaves:
                leaves["gamma"] = rng.uniform(0.5, 1.5, leaves["gamma"].shape).astype(np.float32)
                leaves["beta"] = rng.uniform(-0.5, 0.5, leaves["beta"].shape).astype(np.float32)
    for tree in state.values():
        for leaves in tree.values():
            bias = rng.uniform(0.1, 0.9, leaves["bias"].shape).astype(np.float32)
            keep = (1.0 - bias)[..., None]
            c = leaves["ema_mean"].shape
            leaves["bias"] = bias
            leaves["ema_mean"] = (rng.normal(0, 0.3, c) * keep).astype(np.float32)
            leaves["ema_var"] = (rng.uniform(0.2, 2.0, c) * keep).astype(np.float32)
    return params, state


def tiny_cfg(**kw):
    base = dict(model="experts_n_est", tiny_backbone=True, num_point=N_POINT,
                num_gaussians=8, gmm_variance=0.0156, patch_radius=(0.01, 0.03, 0.05))
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def moe():
    cfg = tiny_cfg()
    gmm = get_3d_grid_gmm([8, 8, 8], variance=cfg.gmm_variance)
    rng = np.random.RandomState(20)
    B = 6
    points = rng.uniform(-1, 1, size=(B, 3 * N_POINT, 3)).astype(np.float32)
    n_eff = rng.randint(0, N_POINT + 1, size=(B, 3)).astype(np.int32)
    n_eff[-1] = 0  # a zero-padded tail row
    for b in range(B):
        for s in range(3):
            points[b, s * N_POINT + n_eff[b, s] + 1 : (s + 1) * N_POINT] = 0.0
    batch = {"points": points, "n_eff": n_eff}
    jmodel = jax_build_model(cfg, gmm)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(3), batch)
    params, state = random_bn(params, state, rng)
    return cfg, gmm, jmodel, params, state, batch


def test_convert_round_trips_bit_exactly(moe):
    cfg, gmm, _, params, state, _ = moe
    sd = convert.from_haiku(params, state, cfg)
    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    model.load_state_dict(sd, strict=True)  # every key and shape matches
    back_p, back_s = convert.to_haiku(model.state_dict(), cfg)
    for orig, back in ((params, back_p), (state, back_s)):
        assert set(orig) == set(back)
        for top in orig:
            assert set(orig[top]) == set(back[top]), top
            for path, leaves in orig[top].items():
                assert set(leaves) == set(back[top][path]), (top, path)
                for name, value in leaves.items():
                    got = back[top][path][name]
                    assert got.shape == np.shape(value), (top, path, name)
                    np.testing.assert_array_equal(got, value, err_msg=f"{top}/{path}/{name}")


def test_dense_apply_matches_jax(moe):
    cfg, gmm, jmodel, params, state, batch = moe
    jout, _ = jmodel.apply(params, state, None, batch, False, 0.0)
    want_pred = np.asarray(jout["n_pred"])
    want_prob = np.asarray(jout["experts_prob"])
    want_ids = np.asarray(jmodel.predict_experts(jout)[0])
    want_normals = np.asarray(jmodel.predict_normals(jout))
    # The seed is chosen so that no patch's top-2 probability gap is below
    # the bar: argmax ids are then well-defined under f32 reordering.
    top2 = np.sort(want_prob, axis=0)[-2:]
    assert np.min(top2[1] - top2[0]) > 1e-4

    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    model.eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(batch["points"]), torch.from_numpy(batch["n_eff"]))
        ids, probs_be = model.predict_experts(out)
        normals = model.predict_normals(out)
    assert out["n_pred"].shape == (7, 6, 3) and out["experts_prob"].shape == (7, 6)
    np.testing.assert_allclose(out["n_pred"].numpy(), want_pred, atol=1e-4)
    np.testing.assert_allclose(out["experts_prob"].numpy(), want_prob, atol=1e-4)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(probs_be.numpy(), want_prob.T, atol=1e-4)
    np.testing.assert_allclose(normals.numpy(), want_normals, atol=1e-4)


def test_expert_grouping_matches_jax(moe):
    cfg, _, jmodel, _, _, _ = moe
    from nestinet_tpu_torch.models.experts import expert_groups

    got = [(g.n_scales, g.indices, g.starts, g.first_width) for g in expert_groups(cfg)]
    want = [(g.n_scales, g.indices, g.starts, g.first_width) for g in jmodel.groups]
    assert got == want == [(1, [0, 1, 2, 3, 4, 5], [0, 0, 20, 20, 40, 40], 128),
                           (3, [6], [0], 42)]


@pytest.mark.parametrize("name", ["CONV_NET_8G", "CONV_NET_3G", "TINY"])
def test_backbone_specs_equal_jax(name):
    assert getattr(backbones, name) == getattr(jax_backbones, name)


@pytest.mark.parametrize("width", [128, 64, 42])
def test_expert_backbone_spec_equals_jax(width):
    assert backbones.expert_backbone_8g(width) == jax_backbones.expert_backbone_8g(width)


def test_flagship_parameter_count():
    """Full-width flagship: the port's module tree holds as many weights as
    the JAX model (counted from its shapes without running it)."""
    cfg = Config(model="experts_n_est")
    gmm = get_3d_grid_gmm([8, 8, 8], variance=cfg.gmm_variance)
    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    jmodel = jax_build_model(cfg, gmm)
    batch = {"points": np.zeros((1, 3 * 512, 3), np.float32),
             "n_eff": np.full((1, 3), 512, np.int32)}
    p_t, s_t = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves((p_t, s_t)))
    n_port = sum(v.numel() for v in model.state_dict().values())
    assert n_port == n_jax
