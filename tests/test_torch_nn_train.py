"""The port's NN blocks in training against the JAX package's, and the
weight init and penalty.

The same seeded numpy input (NDHWC for JAX, NCDHW for the port) and the
same parameters (a haiku init with randomised BatchNorm, converted by
`convert.module_to_torch`) go through haiku's `apply(..., is_training=True,
bn_momentum)` and the port's `forward(..., training=True, momentum)`.
Both the output and the BatchNorm state after the call are compared.

Bars: float32 outputs atol/rtol 1e-4 (`tests/test_torch_nn.py`'s bar: the
convolutions sum in other orders), EMA state atol 1e-6 and rtol 1e-5
(float32 batch moments reduced in other orders, scaled by 1 - m).  In
bfloat16 JAX runs eagerly, one op at a time as the port does, and the batch
moments are float32 in both.  A bare BatchNorm agrees within one bfloat16
ulp on at most 5% of the elements (`test_torch_dtypes.py::assert_bf16_close`).
Behind a k >= 2 conv, whose bfloat16 output XLA and oneDNN round apart
now and then (the eval blocks' 1 ulp on <= 5%), the batch normalization
scales those ulps by 1/std: `assert_bf16_train_close` holds the relative
L2 error at 1% and every element within 2% of max |want| (measured: 0.2-0.4%
and 0.9%, on 6-10% of the elements), the EMA state at atol 1e-3, rtol 1e-2.
"""

import haiku as hk
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.core.config import Config as JaxConfig
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.ops import nn as jnn
from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.models import build_model
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.gmm import GridGMM

from .test_torch_dtypes import assert_bf16_close, to_f32
from .test_torch_nn import TOL, _drop_top, _randomize

torch.set_num_threads(1)

STATE_TOL = dict(atol=1e-6, rtol=1e-5)
MOMENTUM = 0.7


def _to_port(x):
    return x.permute(0, 4, 1, 2, 3) if x.dim() == 5 else x


def _from_port(a):
    return a.transpose(0, 2, 3, 4, 1) if a.ndim == 5 else a


def run_train(make_hk, make_torch, x, rng, dtype="float32", rename=_drop_top):
    """Init the haiku module, randomise its BatchNorms, convert, and run
    both in training; returns ((port out, port state), (JAX out, JAX
    state)), outputs as float32 NDHWC, states as {haiku path: leaves}."""
    f = hk.transform_with_state(make_hk)
    params, state = f.init(jax.random.PRNGKey(rng.randint(1 << 30)), jnp.asarray(x))
    params, state = _randomize(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), rng)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    want, want_state = f.apply(params, state, None, xj)

    module = make_torch()
    module.load_state_dict(convert.module_to_torch(params, state, rename=rename))
    xt = _to_port(torch.from_numpy(to_f32(xj)))
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    got = module(xt, training=True, momentum=MOMENTUM)
    assert got.dtype == xt.dtype
    got_state = {}
    for name, buf in module.named_buffers():
        path, leaf = name.rsplit(".", 1)
        got_state.setdefault(path, {})[leaf] = buf.numpy()
    want_state = {rename(p): {k: np.asarray(v) for k, v in leaves.items()}
                  for p, leaves in want_state.items()}
    return (_from_port(to_f32(got)), got_state), (to_f32(want), want_state)


def assert_bf16_train_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= 0.01 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def check_state(got, want):
    assert set(got) == set(want)
    for path in want:
        for leaf in ("ema_mean", "ema_var", "bias"):
            np.testing.assert_allclose(got[path][leaf], want[path][leaf], **STATE_TOL,
                                       err_msg=f"{path}.{leaf}")


class _BN(torch.nn.Module):
    """A bare BatchNormEMA under the name haiku gives it ("bn")."""

    def __init__(self, c):
        super().__init__()
        self.bn = tnn.BatchNormEMA(c)

    def forward(self, x, training, momentum):
        return self.bn(x, training, momentum)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4, 5, 6, 7), (6, 9)])
def test_batchnorm_train_mode_matches_jax(rng, dtype, shape):
    """Output, ema_mean, ema_var and bias after one training call: the
    population variance over every axis but channels, in float32."""
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    (got, got_s), (want, want_s) = run_train(
        lambda v: jnn.BatchNormEMA(name="bn")(v, True, MOMENTUM),
        lambda: _BN(shape[-1]), x, rng, dtype, rename=lambda p: p.replace("/", "."))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert_bf16_close(got, want)
    check_state(got_s, want_s)
    assert got_s["bn"]["bias"].dtype == np.float32


def test_batchnorm_train_mode_uses_the_population_variance():
    bn = tnn.BatchNormEMA(2)
    x = torch.tensor([[0.0, 1.0], [2.0, 5.0]])
    bn(x, True, 0.0)  # m = 0: the EMA becomes the batch moments
    torch.testing.assert_close(bn.ema_mean, torch.tensor([1.0, 3.0]))
    torch.testing.assert_close(bn.ema_var, torch.tensor([1.0, 4.0]))
    assert bn.bias.item() == 0.0


def test_batchnorm_state_update_stays_out_of_autograd(rng):
    bn = tnn.BatchNormEMA(3)
    x = torch.from_numpy(rng.normal(size=(4, 3, 2, 2, 2)).astype(np.float32)).requires_grad_()
    (bn(x, True, 0.5) ** 2).sum().backward()
    assert x.grad is not None and bn.gamma.grad is not None
    for buf in (bn.ema_mean, bn.ema_var, bn.bias):
        assert not buf.requires_grad and buf.grad_fn is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k1,k2,cin", [(1, 2, 6), (2, 4, 6), (3, 5, 6), (2, 4, 24), (3, 5, 24)])
def test_inception3d_in_training_matches_jax(rng, dtype, k1, k2, cin):
    """In training the pool runs first at every width (cin > n too), and
    it is the non-separable pool; k1 = 2 pads asymmetrically."""
    n = 8
    x = rng.normal(size=(3, 5, 4, 6, cin)).astype(np.float32)
    (got, got_s), (want, want_s) = run_train(
        lambda v: jnn.Inception3D(n, (k1, k2), name="incep")(v, True, MOMENTUM),
        lambda: tnn.Inception3D(cin, n, (k1, k2)), x, rng, dtype)
    assert got.shape == (3, 5, 4, 6, 3 * n)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
        check_state(got_s, want_s)
    else:
        assert_bf16_train_close(got, want)
        for path in want_s:  # moments of bfloat16 activations
            for leaf in ("ema_mean", "ema_var", "bias"):
                np.testing.assert_allclose(got_s[path][leaf], want_s[path][leaf],
                                           atol=1e-3, rtol=1e-2, err_msg=f"{path}.{leaf}")


def test_inception3d_in_training_pools_before_conv4(rng):
    block = tnn.Inception3D(24, 8, (3, 5))
    seen = []
    block.conv4.conv.register_forward_hook(lambda m, inp, out: seen.append(inp[0]))
    x = torch.from_numpy(rng.normal(size=(2, 24, 5, 5, 5)).astype(np.float32))
    block(x, training=True, momentum=0.5)
    torch.testing.assert_close(seen[0], tnn.avg_pool3d(x, 3, 1, separable=False),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [(5, 5, 5), (4, 5, 7)])
@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (3, 1), (4, 1), (5, 1), (2, 2)])
def test_non_separable_avg_pool_matches_jax(rng, dtype, size, k, stride):
    """One k^3 window sum over the SAME-padded input divided by the valid
    count; k = 2 and 4 pad (0, 1) and (1, 2), which F.avg_pool3d's own
    padding cannot express.  float32: atol/rtol 1e-6 (the sums are
    reassociated).  bfloat16: the port sums in float32, rounds the sum once
    and divides in bfloat16, so it is within 2 bfloat16 ulps of the exact
    mean (the rounded sum's half ulp, divided by the count, is at most one
    ulp of the mean); JAX's eager CPU sum accumulates in bfloat16 (36% of
    its k = 3 sums equal the float32 sum rounded), so the two agree within
    JAX's own error plus those 2 ulps."""
    x = (rng.normal(size=(2,) + size + (3,)) * 3).astype(np.float32)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    want = to_f32(jnn.avg_pool3d(xj, k, stride, separable=False))
    x32 = _to_port(torch.from_numpy(to_f32(xj)))
    xt = x32.to(torch.bfloat16) if dtype == "bfloat16" else x32
    got = tnn.avg_pool3d(xt, k, stride, separable=False)
    assert got.dtype == xt.dtype
    got = _from_port(to_f32(got))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        return
    exact = _from_port(tnn.avg_pool3d(x32.double(), k, stride, separable=False).numpy())
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 7)
    assert (np.abs(got - exact) <= 2 * ulp).all()
    assert (np.abs(got - want) <= np.abs(want - exact) + 2 * ulp).all()


def test_non_separable_pool_has_a_gradient(rng):
    x = torch.from_numpy(rng.normal(size=(1, 2, 4, 4, 4)).astype(np.float32)).requires_grad_()
    tnn.avg_pool3d(x, 2, 1, separable=False).sum().backward()
    # every cell is in 8 windows but those at the far border, divided by
    # each window's count
    assert torch.isfinite(x.grad).all() and x.grad.min() > 0


def _tiny_cfgs(**kw):
    base = dict(model="experts_n_est", tiny_backbone=True, num_point=8, num_gaussians=3,
                gmm_variance=1.0 / 9, patch_radius=(0.01, 0.03, 0.05))
    base.update(kw)
    return Config(**base), JaxConfig(**base)


def test_l2_weight_penalty_matches_jax(rng):
    """0.5 sum ||w||^2 over conv and linear kernels only: JAX's on the haiku
    tree and the port's on the converted model agree; biases and
    BatchNorm parameters do not count."""
    cfg, jcfg = _tiny_cfgs()
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    batch = {"points": np.zeros((2, 24, 3), np.float32), "n_eff": np.full((2, 3), 8, np.int32)}
    params, state = jax_build_model(jcfg, gmm).init(jax.random.PRNGKey(4), batch)
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    want = float(jnn.l2_weight_penalty(params))
    got = tnn.l2_weight_penalty(model)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] != "w":
                p.add_(3.0)
    np.testing.assert_allclose(tnn.l2_weight_penalty(model).item(), want, rtol=1e-6)


def test_init_follows_haiku_xavier_uniform():
    """The init fault pin: a model built and not loaded holds xavier-uniform
    kernels on DHWIO fans (JAX `ops/nn.py:36`), zero biases and BatchNorm at
    its defaults, from the generator it was given.  Per kernel: every
    element within +-sqrt(6 / (fan_in + fan_out)); the largest |w| of the
    port and of haiku's init on the same config both near that bound; the
    kernels scaled by it have the moments of U(-1, 1) in both (mean 0,
    variance 1/3, pooled over the model's 123k elements: mean within 0.01,
    variance within 0.005)."""
    import math

    cfg, jcfg = _tiny_cfgs()
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances),
                        torch.Generator().manual_seed(7))
    batch = {"points": np.zeros((2, 24, 3), np.float32), "n_eff": np.full((2, 3), 8, np.int32)}
    params, state = jax_build_model(jcfg, gmm).init(jax.random.PRNGKey(7), batch)
    haiku = convert.from_haiku(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), cfg)
    scaled = {"port": [], "haiku": []}
    sd = model.state_dict()
    assert set(sd) == set(haiku)
    for name, value in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf != "w":
            torch.testing.assert_close(value, haiku[name], rtol=0, atol=0, msg=name)
            continue
        receptive = math.prod(value.shape[2:]) if value.dim() > 2 else 1
        limit = math.sqrt(6.0 / ((value.shape[0] + value.shape[1]) * receptive))
        for who, w in (("port", value), ("haiku", haiku[name])):
            top = w.abs().max().item()
            assert top <= limit * (1 + 1e-6), (who, name, top, limit)
            if w.numel() >= 200:
                assert top >= 0.95 * limit, (who, name, top, limit)
            scaled[who].append((w / limit).flatten())
    for who, parts in scaled.items():
        u = torch.cat(parts).double()
        assert u.numel() > 100_000
        assert abs(u.mean().item()) < 0.01, who
        assert abs(u.var().item() - 1.0 / 3.0) < 0.005, who


def test_init_is_deterministic_in_the_generator():
    cfg, _ = _tiny_cfgs()
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    g = GridGMM(gmm.weights, gmm.means, gmm.covariances)
    a = build_model(cfg, g, torch.Generator().manual_seed(1)).state_dict()
    b = build_model(cfg, g, torch.Generator().manual_seed(1)).state_dict()
    c = build_model(cfg, g, torch.Generator().manual_seed(2)).state_dict()
    d = build_model(cfg, g).state_dict()  # seeded with cfg.seed
    e = build_model(cfg, g, torch.Generator().manual_seed(cfg.seed)).state_dict()
    w = "manager.backbone.incep0.conv1.conv.w"
    assert all(torch.equal(a[k], b[k]) and torch.equal(d[k], e[k]) for k in a)
    assert not torch.equal(a[w], c[w])
