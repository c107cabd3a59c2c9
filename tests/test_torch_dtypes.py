"""The port's blocks and model in bfloat16 and int8 against the JAX package.

The same numpy input goes through a haiku module and its port, in the
serving dtype: float32 parameters cast per op, the input cast to bfloat16,
and under int8 the convs and linears quantized (JAX inside
`quant.quantized(True)`, the port after `quant.quantize_`).  JAX runs
eagerly, one XLA op at a time, so each op rounds to bfloat16 as the port's
does.

Bars: the port follows JAX's op order and casts, so outputs agree to the
last bit but for a convolution or matmul summed in another order now and
then.  `assert_bf16_close` allows one bfloat16 ulp on at most 5% of the
elements (measured: none, but one of 3,360 in the k = 4 conv and one of
64 in the linear).
float32 keeps `tests/test_torch_nn.py`'s bar, atol/rtol 1e-4.

Also here, the three repairs of the port's blocks: the Inception pool
branch in JAX's inference order when cin > n (tested with k1 = 3, where
the pool is not the identity), the separable average pool in x.dtype,
and the bias added after the conv has been rounded.
"""

import dataclasses

import haiku as hk
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nestinet_tpu.ops import fold as jfold
from nestinet_tpu.ops import nn as jnn
from nestinet_tpu.ops import quant as jquant
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.fold import fold_bn_
from nestinet_tpu_torch.ops.quant import quantize_

from .test_torch_nn import TOL, _drop_top, _randomize
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

MODES = ("float32", "bfloat16", "int8")


def to_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_bf16_close(got, want, max_frac=0.05, ulps=1):
    """Elementwise within `ulps` bfloat16 ulps of `want`, and at most
    `max_frac` of the elements not identical."""
    got, want = to_f32(got), to_f32(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    exp = np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny)))
    ulp = np.exp2(exp - 7)  # bfloat16 keeps 8 significant bits
    diff = np.abs(got - want)
    assert (diff <= ulps * ulp).all(), diff.max()
    assert np.mean(diff > 0) <= max_frac, np.mean(diff > 0)


def run_block(make_hk, make_torch, x, rng, mode, rename=_drop_top):
    """Init the haiku module, randomise its BatchNorms, convert, and run
    both in `mode`; returns (port output, JAX output) as float32, NDHWC."""
    f = hk.transform_with_state(make_hk)
    params, state = f.init(jax.random.PRNGKey(rng.randint(1 << 30)), jnp.asarray(x))
    params, state = _randomize(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), rng)
    xj = jnp.asarray(x)
    if mode != "float32":
        xj = xj.astype(jnp.bfloat16)
    with jquant.quantized(mode == "int8"):
        want, _ = f.apply(params, state, None, xj)
    want = to_f32(jnn.unwrap(want)[0])

    module = make_torch()
    module.load_state_dict(convert.module_to_torch(params, state, rename=rename))
    module.eval()
    if mode == "int8":
        quantize_(module)
    xt = torch.from_numpy(to_f32(xj))
    if mode != "float32":
        xt = xt.to(torch.bfloat16)
    if xt.dim() == 5:
        xt = xt.permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        got = tnn.unwrap(module(xt))[0]
    assert got.dtype == (torch.float32 if mode == "float32" else torch.bfloat16)
    got = to_f32(got)
    if got.ndim == 5:
        got = got.transpose(0, 2, 3, 4, 1)
    return got, want


def check(got, want, mode):
    if mode == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_convbn3d_in_serving_dtypes(rng, k, mode):
    x = rng.normal(size=(2, 5, 6, 7, 6)).astype(np.float32)
    got, want = run_block(lambda x: jnn.ConvBN3D(8, k, name="cbn")(x, False, 0.0),
                          lambda: tnn.ConvBN3D(6, 8, k), x, rng, mode)
    assert got.shape == (2, 5, 6, 7, 8)
    check(got, want, mode)


@pytest.mark.parametrize("mode", MODES[1:])
def test_densebn_in_serving_dtypes(rng, mode):
    x = rng.normal(size=(4, 24)).astype(np.float32)
    got, want = run_block(lambda x: jnn.DenseBN(16, bn=True, name="fc")(x, False, 0.0),
                          lambda: tnn.DenseBN(24, 16, bn=True), x, rng, mode)
    check(got, want, mode)


@pytest.mark.parametrize("size", [(5, 5, 5), (8, 8, 8), (4, 5, 7)])
@pytest.mark.parametrize("k,stride", [(2, 1), (3, 1), (5, 1), (2, 2), (3, 2)])
def test_avg_pool_bfloat16_equals_jax(rng, size, k, stride):
    """Repair 2: the separable pool, summed one cell at a time in x.dtype
    and divided by the outer product of per-axis counts, as JAX serves it
    (`nestinet_tpu/ops/nn.py:394-414`): identical in bfloat16, eager and
    jitted.  `F.avg_pool3d` has no bfloat16 kernel on the CPU and rounds
    differently."""
    x = (rng.normal(size=(2,) + size + (4,)) * 3).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(to_f32(xj)).to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    got = to_f32(tnn.avg_pool3d(xt, k, stride)).transpose(0, 2, 3, 4, 1)
    for want in (jnn.avg_pool3d(xj, k, stride),
                 jax.jit(lambda v: jnn.avg_pool3d(v, k, stride))(xj)):
        np.testing.assert_array_equal(got, to_f32(want))


def test_avg_pool_keeps_the_bound(rng):
    x = torch.from_numpy(rng.normal(size=(1, 3, 4, 4, 4)).astype(np.float32))
    amax = torch.tensor(7.0)
    for pool in (tnn.avg_pool3d, tnn.max_pool3d):
        out = pool(tnn.ActQ(x, amax), 2, 2)
        assert isinstance(out, tnn.ActQ) and out.amax is amax


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cin,n", [(24, 8), (6, 8)])
def test_inception3d_k1_3_in_serving_dtypes(rng, mode, cin, n):
    """Repair 1: with k1 = 3 the pool is not the identity, so pooling
    before or after conv4 are different functions up to reassociation in
    float32, and under int8 they quantize different tensors (x against
    avgpool(x)).  JAX pools after conv4 + BN when cin > n."""
    x = rng.normal(size=(2, 6, 6, 6, cin)).astype(np.float32)
    got, want = run_block(lambda x: jnn.Inception3D(n, (3, 5), name="incep")(x, False, 0.0),
                          lambda: tnn.Inception3D(cin, n, (3, 5)), x, rng, mode)
    assert got.shape == (2, 6, 6, 6, 3 * n)
    check(got, want, mode)


@pytest.mark.parametrize("cin,pooled_first", [(24, False), (8, True), (6, True)])
def test_inception3d_conv4_input_follows_jax(rng, cin, pooled_first):
    """Repair 1, directly: conv4 reads the block's input when cin > n and
    its average pool when cin <= n."""
    block = tnn.Inception3D(cin, 8, (3, 5)).eval()
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.2)
    seen = []
    block.conv4.conv.register_forward_hook(lambda m, inp, out: seen.append(inp[0]))
    x = torch.from_numpy(rng.normal(size=(1, cin, 5, 5, 5)).astype(np.float32))
    with torch.inference_mode():
        block(x)
    want = tnn.avg_pool3d(x, 3, 1) if pooled_first else x
    torch.testing.assert_close(seen[0], want, rtol=0, atol=0)


def test_bias_is_added_after_the_conv_is_rounded(rng):
    """Repair 3: JAX rounds the bfloat16 conv, then adds the bias in
    bfloat16 (`nestinet_tpu/ops/nn.py:157`); `F.conv3d(x, w, b)` adds it
    before rounding and differs on many elements."""
    x = rng.normal(size=(2, 5, 5, 5, 6)).astype(np.float32)
    f = hk.transform(lambda x: jnn._Conv3DParamF32(8, (3, 3, 3), 1, name="conv")(x))
    params = jax.tree.map(np.asarray, f.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["conv"]["b"] = rng.uniform(-3, 3, 8).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = to_f32(f.apply(params, None, xj)).transpose(0, 4, 1, 2, 3)

    conv = tnn._Conv3D(6, 8, 3)
    sd = convert.module_to_torch(params, {})
    conv.load_state_dict({"w": sd["conv.w"], "b": sd["conv.b"]})
    xt = torch.from_numpy(to_f32(xj)).to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        got = to_f32(conv(xt))
        fused = to_f32(F.conv3d(xt, conv.w.to(torch.bfloat16), conv.b.to(torch.bfloat16),
                                padding=1))
    assert_bf16_close(got, want)
    assert np.mean(fused != want) > 0.05  # the fused bias rounds elsewhere


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def trained():
    """A tiny flagship trained a few JAX steps (as `tests/test_int8.py`
    does, on a batch of 32 patches so that the eval BatchNorms are well
    conditioned) and a batch of 32 patches to serve."""
    from .test_int8 import _tiny_cfg, _train_few_steps

    rng = np.random.RandomState(5)
    cfg = _tiny_cfg("float32")
    normals = rng.normal(size=(32, 3))
    train_batch = {
        "points": rng.uniform(-1, 1, size=(32, 16, 3)).astype(np.float32),
        "n_eff": rng.randint(1, 9, size=(32, 2)).astype(np.int32),
        "normals": (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32),
    }
    _, params, state = _train_few_steps(cfg, train_batch, n=12)
    batch = {"points": rng.uniform(-1, 1, size=(32, 16, 3)).astype(np.float32),
             "n_eff": rng.randint(0, 9, size=(32, 2)).astype(np.int32)}
    return cfg, jax.device_get(params), jax.device_get(state), batch


def jax_serve(cfg, params, state, batch, dtype, fold_bn):
    """JAX's restore path (fold, then quantize, on the host) and its eager
    apply: (normals [B, 3], probabilities [E, B])."""
    from nestinet_tpu.models import build_model as jax_build_model
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm

    c = dataclasses.replace(cfg, compute_dtype=dtype, fold_bn=fold_bn)
    model = jax_build_model(c, get_3d_grid_gmm([c.num_gaussians] * 3, variance=c.gmm_variance))
    if fold_bn:
        params, state = jfold.fold_bn_params_np(params, state)
    if dtype == "int8":
        params = jquant.quantize_params_np(params)
    out, _ = model.apply(params, state, None, batch, False, 0.0)
    return to_f32(model.predict_normals(out)), to_f32(out["experts_prob"])


def port_serve(cfg, params, state, batch, dtype, fold_bn):
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm

    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import GridGMM

    c = dataclasses.replace(cfg, compute_dtype=dtype, fold_bn=fold_bn)
    g = get_3d_grid_gmm([c.num_gaussians] * 3, variance=c.gmm_variance)
    model = build_model(c, GridGMM(g.weights, g.means, g.covariances))
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    if model.fold_bn:
        fold_bn_(model)
    if model.quantize:
        quantize_(model)
    model.eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(batch["points"]), torch.from_numpy(batch["n_eff"]))
    assert out["n_pred"].dtype == out["experts_prob"].dtype == torch.float32
    return to_f32(model.predict_normals(out)), to_f32(out["experts_prob"])


def angles_deg(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return np.degrees(np.arccos(np.clip(np.abs((a * b).sum(1)), 0.0, 1.0)))


@pytest.mark.parametrize("dtype,fold_bn", [
    ("bfloat16", False), ("bfloat16", True), ("int8", False), ("int8", True),
    ("float32", True),
])
def test_model_in_serving_dtypes_matches_jax(trained, dtype, fold_bn):
    """Dense MoE on trained weights: probabilities within 1e-5, the same
    argmax ids, normals within 1e-2 (about one bfloat16 ulp at their
    size) and 0.5 degrees.  Measured on this batch: probabilities 3e-8
    apart, normals identical, in every mode.  For scale, JAX's own
    bfloat16 differs from its float32 by 0.010 in probability and 5
    degrees, and its int8 by 0.022 and 69 degrees."""
    cfg, params, state, batch = trained
    want_n, want_p = jax_serve(cfg, params, state, batch, dtype, fold_bn)
    got_n, got_p = port_serve(cfg, params, state, batch, dtype, fold_bn)
    assert np.isfinite(got_n).all() and np.isfinite(got_p).all()
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)
    np.testing.assert_array_equal(got_p.argmax(0), want_p.argmax(0))
    np.testing.assert_allclose(got_n, want_n, atol=1e-2, rtol=1e-2)
    assert angles_deg(got_n, want_n).max() < 0.5


def test_serving_dtypes_move_the_outputs(trained):
    """The modes are really different computations: bfloat16 and int8 each
    move the probabilities off float32's."""
    cfg, params, state, batch = trained
    _, p32 = port_serve(cfg, params, state, batch, "float32", False)
    _, p16 = port_serve(cfg, params, state, batch, "bfloat16", False)
    _, p8 = port_serve(cfg, params, state, batch, "int8", False)
    assert np.abs(p16 - p32).max() > 1e-4
    assert np.abs(p8 - p16).max() > 1e-4
