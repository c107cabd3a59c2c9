"""The port's single-scale, multi-scale and noise-switching models against
the JAX package's, in eval.

Each case builds the JAX model on a seeded numpy batch (random n_eff, some
radii zero-padded), randomises its BatchNorm state, converts the haiku tree
with `convert.from_haiku` and runs both packages on the same batch; the
switching model's noise head is first moved so that its estimates
straddle the 0.015 switch and both branches are taken: in float32 only its
bias moves (its weights keep haiku's TruncatedNormal(1e-3) init), in the
serving dtypes its weights are also scaled to spread the estimates by about
0.01, wider than a bfloat16 rounding of them.  The JAX ablation
models ignore `tiny_backbone`, so the narrow cases replace both packages'
ablation backbones by the one-block `TINY` spec for the test (module state,
never a file); one case per model runs the full-depth backbones at a 3^3
Gaussian grid.

Bars:
  * float32: normals within atol 1e-5; the switching model's noise estimate
    within atol 1e-6 and its switch identical except where
    |noise - 0.015| < 1e-5;
  * bfloat16, int8 and int8 / bfloat16 with BatchNorm folded, against eager
    JAX (one XLA op at a time, as `tests/test_torch_dtypes.py` holds the
    mixture of experts): normals within one bfloat16 rounding (rtol 2^-7,
    atol 1e-4) and 0.5 degrees; the noise estimate within 2.5e-4 of JAX's
    (one bfloat16 step below 0.0625), the switch identical except where
    JAX's noise lies within 2.5e-4 of the threshold, at most one of the 8
    patches left out.  The port equals eager JAX bit for bit on the noise
    estimate in every case here, and on the normals but for one bfloat16
    step (3.9e-3 at 0.55, SS bfloat16 folded).  Each case also reads the
    control: the port's float32 outputs against JAX's in the dtype, which
    the bars must refuse (noise gaps 9.9e-4 to 5.5e-3).
Also here: the backbone specs equal JAX's, the converter round-trips bit
for bit, the full-width models hold as many weights as JAX's, the switching
loss and the noise head's init follow JAX, and the port's dropout (rate,
1/keep scaling, off in eval, replayed masks).
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from nestinet_tpu.core.config import Config as JaxConfig
from nestinet_tpu.models import backbones as jax_backbones
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.models import losses as jax_losses
from nestinet_tpu.ops import fold as jfold
from nestinet_tpu.ops import quant as jquant
from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.models import build_model, losses
from nestinet_tpu_torch.models import backbones
from nestinet_tpu_torch.models.switching import NOISE_SWITCH_THRESHOLD
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.fold import fold_bn_
from nestinet_tpu_torch.ops.gmm import GridGMM
from nestinet_tpu_torch.ops.quant import quantize_

from .test_torch_dtypes import to_f32
from .test_torch_experts import random_bn
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

ABLATIONS = {"ss_norm_est": (0.05,), "ms_norm_est": (0.01, 0.03, 0.05),
             "ms_sw_n_est": (0.01, 0.05)}
NARROWED = ("SS_BACKBONE", "MS_BACKBONE_8G", "SW_BACKBONE", "CONV_NET_3G")
N_POINT = 16
BATCH = 8
SWITCH_GAP = 1e-5
DTYPE_RTOL = 2.0 ** -7  # one bfloat16 rounding
DTYPE_ATOL = 1e-4
DTYPE_NOISE_ATOL = 2.5e-4  # one bfloat16 step of a noise estimate below 0.0625


@contextlib.contextmanager
def narrow_backbones():
    """Both packages' ablation backbones replaced by the one-block TINY spec
    (JAX reads them when it traces, the port when it builds)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in NARROWED:
            mp.setattr(jax_backbones, name, jax_backbones.TINY)
            mp.setattr(backbones, name, backbones.TINY)
        yield


@pytest.fixture
def narrow():
    with narrow_backbones():
        yield


def ablation_cfgs(model: str, **kw):
    base = dict(model=model, num_point=N_POINT, num_gaussians=3, gmm_variance=1.0 / 9,
                patch_radius=ABLATIONS[model], batch_size=BATCH, loss_type="sin")
    base.update(kw)
    return Config(**base), JaxConfig(**base)


def make_batch(n_scales: int, seed: int, batch: int = BATCH) -> dict:
    """Points in [-1, 1]^3 with random n_eff (one radius of one patch
    empty), zeros past n_eff; unit normals and noise levels as targets."""
    rng = np.random.RandomState(seed)
    points = rng.uniform(-1, 1, size=(batch, n_scales * N_POINT, 3)).astype(np.float32)
    n_eff = rng.randint(1, N_POINT + 1, size=(batch, n_scales)).astype(np.int32)
    n_eff[-1, 0] = 0
    for b in range(batch):
        for s in range(n_scales):
            points[b, s * N_POINT + n_eff[b, s]:(s + 1) * N_POINT] = 0.0
    normals = rng.normal(size=(batch, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return {"points": points, "n_eff": n_eff, "normals": normals.astype(np.float32),
            "noise": rng.uniform(0.0, 0.03, size=batch).astype(np.float32)}


def random_bn_flat(params, state, rng):
    """`random_bn` on a flat haiku tree."""
    params, state = random_bn({"t": params}, {"t": state}, rng)
    return params["t"], state["t"]


def port_model(cfg, gmm, params, state):
    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    return model.eval()


def spread_noise_head(cfg, gmm, params, state, batch, spread=None):
    """Move the noise head's last layer so that its median estimate on
    `batch` is 0.015 (half the patches take each branch): its bias, and with
    `spread` its weights too, scaled so that the estimates' standard
    deviation is `spread`."""
    model = port_model(cfg, gmm, params, state)
    head = model.noise.head
    with torch.no_grad():
        grid = model.mups_grid(torch.from_numpy(batch["points"]),
                               torch.from_numpy(batch["n_eff"]))
        h = model.noise.backbone(grid.permute(0, 4, 1, 2, 3)[:, 20:])
        h = head.fc3(head.fc2(head.fc1(h))).numpy()
    last = params["noise_fc4/linear"]
    z = (h @ last["w"])[:, 0]
    scale = 1.0 if spread is None else spread / z.std()
    last["w"] = (last["w"] * scale).astype(np.float32)
    last["b"] = np.float32([NOISE_SWITCH_THRESHOLD - np.median(z * scale)])


def make_case(model: str, seed: int = 3, spread=None, **cfg_kw):
    """(cfg, jcfg, gmm, params, state, batch) of one JAX-initialized model;
    `spread` as in `spread_noise_head`."""
    cfg, jcfg = ablation_cfgs(model, **cfg_kw)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=jcfg.gmm_variance)
    batch = make_batch(len(ABLATIONS[model]), seed)
    jm = jax_build_model(jcfg, gmm)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(seed), batch)
    params, state = random_bn_flat(jax.device_get(params), jax.device_get(state),
                                   np.random.RandomState(seed + 1))
    if model == "ms_sw_n_est":
        spread_noise_head(cfg, gmm, params, state, batch, spread)
    return cfg, jcfg, gmm, params, state, batch


def jax_eval(jcfg, gmm, params, state, batch, jit=True):
    jm = jax_build_model(jcfg, gmm)
    fn = lambda p, s, b: jm.apply(p, s, None, b, False, 0.0)[0]  # noqa: E731
    out = (jax.jit(fn) if jit else fn)(params, state, batch)
    return {k: to_f32(v) for k, v in out.items()}


def port_eval(model, batch):
    with torch.inference_mode():
        out = model(torch.from_numpy(batch["points"]), torch.from_numpy(batch["n_eff"]))
    assert all(v.dtype == torch.float32 for v in out.values())
    return {k: v.numpy() for k, v in out.items()}


def check_switch(got, want, gap):
    """The switch identical wherever JAX's noise is more than `gap` from
    the threshold; both branches taken."""
    sure = np.abs(want["noise_pred"] - NOISE_SWITCH_THRESHOLD) >= gap
    mask_w = want["noise_pred"] < NOISE_SWITCH_THRESHOLD
    mask_g = got["noise_pred"] < NOISE_SWITCH_THRESHOLD
    np.testing.assert_array_equal(mask_g[sure], mask_w[sure])
    assert 0 < mask_w.sum() < mask_w.size  # both branches
    return sure & (mask_g == mask_w)


# ------------------------------------------------------------ specs, sizes


@pytest.mark.parametrize("name", ["SS_BACKBONE", "MS_BACKBONE_8G", "SW_BACKBONE"])
def test_ablation_backbone_specs_equal_jax(name):
    assert getattr(backbones, name) == getattr(jax_backbones, name)


@pytest.mark.parametrize("model", sorted(ABLATIONS))
def test_full_width_parameter_count(model):
    """At 8^3 Gaussians and full width the port holds as many weights and
    BatchNorm state entries as JAX's model (counted from its shapes)."""
    cfg, jcfg = ablation_cfgs(model, num_gaussians=8, gmm_variance=0.0156, num_point=512)
    gmm = get_3d_grid_gmm([8, 8, 8], variance=0.0156)
    ported = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    batch = {"points": np.zeros((1, cfg.n_scales * 512, 3), np.float32),
             "n_eff": np.full((1, cfg.n_scales), 512, np.int32)}
    p_t, s_t = jax.eval_shape(jax_build_model(jcfg, gmm).init, jax.random.PRNGKey(0), batch)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves((p_t, s_t)))
    assert sum(v.numel() for v in ported.state_dict().values()) == n_jax
    params, state = convert.to_haiku(ported.state_dict(), cfg)
    shapes = lambda t: {(k, n): tuple(v.shape) for k, d in t.items() for n, v in d.items()}  # noqa
    assert shapes(params) == shapes(p_t) and shapes(state) == shapes(s_t)


def test_build_model_builds_all_four_families():
    gmm = get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9)
    g = GridGMM(gmm.weights, gmm.means, gmm.covariances)
    kinds = {}
    with narrow_backbones():
        for model, radii in {**ABLATIONS, "experts_n_est": (0.01, 0.03, 0.05)}.items():
            cfg = Config(model=model, tiny_backbone=True, num_gaussians=3, patch_radius=radii)
            kinds[model] = type(build_model(cfg, g)).__name__
    assert kinds == {"ss_norm_est": "SSNormEst", "ms_norm_est": "MSNormEst",
                     "ms_sw_n_est": "SwitchingNormEst", "experts_n_est": "ExpertsNormEst"}
    with pytest.raises(ValueError, match="single patch radius"):
        build_model(Config(model="ss_norm_est", num_gaussians=3, patch_radius=(0.1, 0.2)), g)
    with pytest.raises(ValueError, match="two patch radii"):
        build_model(Config(model="ms_sw_n_est", num_gaussians=3, patch_radius=(0.1,)), g)
    with pytest.raises(ValueError, match="unknown model"):
        build_model(Config(model="pointnet"), g)


@pytest.mark.parametrize("model", sorted(ABLATIONS))
def test_convert_round_trips_bit_exactly(narrow, model):
    cfg, _, gmm, params, state, _ = make_case(model)
    ported = port_model(cfg, gmm, params, state)
    back_p, back_s = convert.to_haiku(ported.state_dict(), cfg)
    for want, got in ((params, back_p), (state, back_s)):
        assert got.keys() == want.keys()
        for path in want:
            assert got[path].keys() == want[path].keys()
            for leaf in want[path]:
                np.testing.assert_array_equal(got[path][leaf], want[path][leaf])


# ------------------------------------------------------------- float32


@pytest.mark.parametrize("depth", ["narrow", "full"])
@pytest.mark.parametrize("model", sorted(ABLATIONS))
def test_eval_matches_jax_in_float32(model, depth):
    ctx = narrow_backbones() if depth == "narrow" else contextlib.nullcontext()
    with ctx:
        cfg, jcfg, gmm, params, state, batch = make_case(model)
        want = jax_eval(jcfg, gmm, params, state, batch)
        got = port_eval(port_model(cfg, gmm, params, state), batch)
    assert got.keys() == want.keys()
    assert np.isfinite(got["n_pred"]).all() and np.abs(want["n_pred"]).max() > 0.1
    if model != "ms_sw_n_est":
        np.testing.assert_allclose(got["n_pred"], want["n_pred"], atol=1e-5, rtol=0)
        return
    np.testing.assert_allclose(got["noise_pred"], want["noise_pred"], atol=1e-6, rtol=0)
    same = check_switch(got, want, SWITCH_GAP)
    np.testing.assert_allclose(got["n_pred"][same], want["n_pred"][same], atol=1e-5, rtol=0)


def test_switch_follows_the_threshold(narrow):
    """The normal is the small-scale net's below 0.015 and the large-scale
    net's at or above it."""
    cfg, _, gmm, params, state, batch = make_case("ms_sw_n_est", spread=0.01)
    model = port_model(cfg, gmm, params, state)
    with torch.inference_mode():
        grid = model.mups_grid(torch.from_numpy(batch["points"]),
                               torch.from_numpy(batch["n_eff"]))
        out = model.forward_grid(grid)
        x = grid.permute(0, 4, 1, 2, 3)
        small, large = model.small(x[:, :20]), model.large(x[:, 20:])
    below = out["noise_pred"] < NOISE_SWITCH_THRESHOLD
    assert 0 < int(below.sum()) < BATCH
    torch.testing.assert_close(out["n_pred"][below], small[below], rtol=0, atol=0)
    torch.testing.assert_close(out["n_pred"][~below], large[~below], rtol=0, atol=0)
    assert (out["noise_pred"] >= 0).all()


# ------------------------------------------------------- serving dtypes


def jax_serve(jcfg, gmm, params, state, batch, dtype, fold_bn):
    """JAX's restore path (fold, then quantize, on the host), then its
    eager apply."""
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype, fold_bn=fold_bn)
    if fold_bn:
        params, state = jfold.fold_bn_params_np(params, state)
    if dtype == "int8":
        params = jquant.quantize_params_np(params)
    return jax_eval(jcfg, gmm, params, state, batch, jit=False)


def port_serve(cfg, gmm, params, state, batch, dtype, fold_bn):
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, fold_bn=fold_bn)
    model = port_model(cfg, gmm, params, state)
    if model.fold_bn:
        fold_bn_(model)
    if model.quantize:
        quantize_(model)
    return port_eval(model, batch)


def angles_deg(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return np.degrees(np.arccos(np.clip(np.abs((a * b).sum(1)), 0.0, 1.0)))


@pytest.mark.parametrize("dtype,fold_bn", [
    ("bfloat16", False), ("bfloat16", True), ("int8", False), ("int8", True),
])
@pytest.mark.parametrize("model", sorted(ABLATIONS))
def test_serving_dtypes_match_eager_jax(narrow, model, dtype, fold_bn):
    cfg, jcfg, gmm, params, state, batch = make_case(model, spread=0.01)
    want = jax_serve(jcfg, gmm, params, state, batch, dtype, fold_bn)
    got = port_serve(cfg, gmm, params, state, batch, dtype, fold_bn)
    control = port_serve(cfg, gmm, params, state, batch, "float32", fold_bn)
    assert np.isfinite(got["n_pred"]).all()
    keep = np.ones(BATCH, bool)
    if model == "ms_sw_n_est":
        np.testing.assert_allclose(got["noise_pred"], want["noise_pred"],
                                   atol=DTYPE_NOISE_ATOL, rtol=0)
        assert np.abs(control["noise_pred"] - want["noise_pred"]).max() > DTYPE_NOISE_ATOL
        keep = check_switch(got, want, DTYPE_NOISE_ATOL)
        assert keep.sum() >= BATCH - 1
    np.testing.assert_allclose(got["n_pred"][keep], want["n_pred"][keep],
                               atol=DTYPE_ATOL, rtol=DTYPE_RTOL)
    assert not np.allclose(control["n_pred"], want["n_pred"], atol=DTYPE_ATOL, rtol=DTYPE_RTOL)
    assert angles_deg(got["n_pred"][keep], want["n_pred"][keep]).max() < 0.5


def test_serving_dtypes_move_the_outputs(narrow):
    """bfloat16 and int8 are really other computations than float32."""
    cfg, _, gmm, params, state, batch = make_case("ss_norm_est")
    outs = {d: port_serve(cfg, gmm, params, state, batch, d, False)["n_pred"]
            for d in ("float32", "bfloat16", "int8")}
    assert np.abs(outs["bfloat16"] - outs["float32"]).max() > 1e-4
    assert np.abs(outs["int8"] - outs["bfloat16"]).max() > 1e-4


# ----------------------------------------------------------- loss, init


@pytest.mark.parametrize("loss_type", ["cos", "euclidean", "sin"])
def test_switching_loss_matches_jax(loss_type):
    batch = make_batch(2, 9)
    rng = np.random.RandomState(2)
    n_pred = rng.normal(size=(BATCH, 3)).astype(np.float32)
    noise_pred = rng.uniform(0, 0.03, BATCH).astype(np.float32)
    want = jax_losses.switching_loss(noise_pred, batch["noise"], n_pred, batch["normals"],
                                     loss_type)
    got = losses.switching_loss(torch.from_numpy(noise_pred), torch.from_numpy(batch["noise"]),
                                torch.from_numpy(n_pred), torch.from_numpy(batch["normals"]),
                                loss_type)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_noise_head_init_follows_haiku():
    """The noise head's last layer: TruncatedNormal(1e-3) cut at 2 standard
    deviations, as haiku's, and bias 0.015; the other heads xavier and 0."""
    cfg = Config(model="ms_sw_n_est", num_gaussians=3, patch_radius=(0.01, 0.05))
    gmm = get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9)
    with narrow_backbones():
        model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances),
                            torch.Generator().manual_seed(4))
        jm = jax_build_model(JaxConfig(**dataclasses.asdict(cfg)), gmm)
        b = make_batch(2, 1)
        params, _ = jax.jit(jm.init)(jax.random.PRNGKey(4), b)
    w = model.noise.head.fc4.linear.w.detach().numpy()
    jw = np.asarray(params["noise_fc4/linear"]["w"])
    for a in (w, jw):
        assert np.abs(a).max() <= 2e-3 and 0.7e-3 < a.std() < 1.0e-3
    assert model.noise.head.fc4.linear.b.item() == np.float32(0.015)
    assert np.asarray(params["noise_fc4/linear"]["b"]).item() == np.float32(0.015)
    assert model.large.head.fc4.linear.b.abs().max() == 0
    assert model.large.head.fc4.linear.w.abs().max() > 0.05


# ------------------------------------------------------------- dropout


def test_dropout_rate_scaling_and_eval():
    x = torch.ones(200_000)
    y = tnn.dropout(x, 0.3, True, tnn.Dropout(torch.Generator().manual_seed(1)))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / 0.7))
    assert tnn.dropout(x, 0.3, False) is x
    assert tnn.dropout(x, 0.0, True) is x
    with pytest.raises(ValueError):
        tnn.dropout(x, 1.0, True)
    a = tnn.dropout(x, 0.3, True, tnn.Dropout(torch.Generator().manual_seed(5)))
    b = tnn.dropout(x, 0.3, True, tnn.Dropout(torch.Generator().manual_seed(5)))
    assert torch.equal(a, b)


def test_dropout_replays_masks_as_haiku_applies_them():
    """Given haiku's keep mask, the port computes hk.dropout's
    keep * x / keep_rate bit for bit."""
    import haiku as hk

    x = np.random.RandomState(0).normal(size=(6, 50)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(hk.dropout(key, 0.3, x))
    keep = np.asarray(jax.random.bernoulli(key, 0.7, x.shape))
    got = tnn.dropout(torch.from_numpy(x), 0.3, True,
                      tnn.Dropout(masks=[torch.from_numpy(keep.copy())]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model", ["ss_norm_est", "ms_norm_est"])
def test_dropout_runs_in_training_only(narrow, model):
    """The head drops in training (two seeds give two outputs, one seed
    one) and not in eval; the switching model has no dropout."""
    cfg, _, gmm, params, state, batch = make_case(model)
    m = port_model(cfg, gmm, params, state)
    pts, ne = torch.from_numpy(batch["points"]), torch.from_numpy(batch["n_eff"])

    def train_out(seed):
        with torch.no_grad():
            return m(pts, ne, True, 0.5, tnn.Dropout(torch.Generator().manual_seed(seed)))["n_pred"]

    assert torch.equal(train_out(1), train_out(1))
    assert not torch.equal(train_out(1), train_out(2))
    m.load_state_dict(convert.from_haiku(params, state, cfg))
    m.eval()
    with torch.no_grad():
        a = m(pts, ne, dropout_masks=tnn.Dropout(torch.Generator().manual_seed(1)))["n_pred"]
        b = m(pts, ne)["n_pred"]
    assert torch.equal(a, b)
    assert m.net.head.dropout_rate == 0.3
