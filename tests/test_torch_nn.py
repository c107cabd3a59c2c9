"""The port's NN blocks (eval path) against the JAX/haiku reference.

Parameters come from a haiku init; BatchNorm parameters and state are
randomised (ema_var > 0, bias in (0.1, 0.9), so the zero-debiasing is
exercised) and carried into the port by `convert.module_to_torch`.  The
same numpy input (NDHWC for JAX, permuted to NCDHW for the port) goes
through both.

Bar: float32 atol 1e-4, rtol 1e-4.  The two packages sum convolutions in
different orders (XLA:CPU vs oneDNN/ATen), and the JAX Inception block on
its cin > n eval branch pools after the 1x1x1 conv where the port pools
before it; both are exact up to float reassociation.
"""

import haiku as hk
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.ops import nn as jnn
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _randomize(params, state, rng):
    """Random BN affine and state; conv/linear weights stay haiku's."""
    params = {p: dict(v) for p, v in params.items()}
    state = {p: dict(v) for p, v in state.items()}
    for path, leaves in params.items():
        if "gamma" in leaves:
            c = leaves["gamma"].shape
            leaves["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            leaves["beta"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        if "b" in leaves:
            leaves["b"] = rng.uniform(-0.1, 0.1, leaves["b"].shape).astype(np.float32)
    for path, leaves in state.items():
        c = leaves["ema_mean"].shape
        bias = np.float32(rng.uniform(0.1, 0.9))
        leaves["bias"] = np.asarray(bias, np.float32)
        leaves["ema_mean"] = (rng.normal(0, 0.3, c) * (1 - bias)).astype(np.float32)
        leaves["ema_var"] = (rng.uniform(0.2, 2.0, c) * (1 - bias)).astype(np.float32)
    return params, state


def _drop_top(path):
    """'name/conv1/conv' -> 'conv1.conv': the haiku module's own name is the
    torch module itself."""
    return path.split("/", 1)[1].replace("/", ".")


def _run_both(make_hk, make_torch, x_ndhwc, rng, rename=_drop_top):
    """Init the haiku module, randomise, convert, run both on the input."""
    f = hk.transform_with_state(make_hk)
    params, state = f.init(jax.random.PRNGKey(rng.randint(1 << 30)), jnp.asarray(x_ndhwc))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    params, state = _randomize(params, state, rng)
    want, _ = f.apply(params, state, None, jnp.asarray(x_ndhwc))
    want = np.asarray(want)

    module = make_torch()
    sd = convert.module_to_torch(params, state, rename=rename)
    module.load_state_dict(sd, strict=True)
    module.eval()
    x = torch.from_numpy(x_ndhwc)
    if x.dim() == 5:
        x = x.permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        got = module(x)
    if got.dim() == 5:
        got = got.permute(0, 2, 3, 4, 1)
    return got.numpy(), want


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_convbn3d(rng, k):
    x = rng.normal(size=(2, 5, 6, 7, 6)).astype(np.float32)
    got, want = _run_both(
        lambda x: jnn.ConvBN3D(8, k, name="cbn")(x, False, 0.0),
        lambda: tnn.ConvBN3D(6, 8, k),
        x, rng,
    )
    assert got.shape == want.shape == (2, 5, 6, 7, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_densebn(rng):
    x = rng.normal(size=(4, 24)).astype(np.float32)
    got, want = _run_both(
        lambda x: jnn.DenseBN(16, bn=True, name="fc")(x, False, 0.0),
        lambda: tnn.DenseBN(24, 16, bn=True),
        x, rng,
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [(5, 5, 5), (8, 8, 8), (4, 5, 7)])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_pools(rng, size, k, stride):
    x = rng.normal(size=(2,) + size + (3,)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    for jfn, tfn in ((jnn.max_pool3d, tnn.max_pool3d), (jnn.avg_pool3d, tnn.avg_pool3d)):
        want = np.asarray(jfn(jnp.asarray(x), k, stride))
        got = tfn(xt, k, stride).permute(0, 2, 3, 4, 1).numpy()
        assert got.shape == want.shape, (jfn.__name__, got.shape, want.shape)
        np.testing.assert_allclose(got, want, err_msg=jfn.__name__, **TOL)


@pytest.mark.parametrize("cin,n,ks", [
    (6, 8, (3, 5)),   # cin <= n: the reference-order pool branch
    (20, 8, (2, 4)),  # cin > n: JAX commutes the pool past conv4 + BN
    (20, 8, (1, 2)),
])
def test_inception3d(rng, cin, n, ks):
    x = rng.normal(size=(2, 6, 6, 6, cin)).astype(np.float32)
    got, want = _run_both(
        lambda x: jnn.Inception3D(n, ks, name="incep")(x, False, 0.0),
        lambda: tnn.Inception3D(cin, n, ks),
        x, rng,
    )
    assert got.shape == want.shape == (2, 6, 6, 6, 3 * n)
    np.testing.assert_allclose(got, want, **TOL)


def test_inception3d_full_width(rng):
    """The flagship manager's first block, incep(128, (3, 5)), on a 3-scale
    8^3 MuPS grid."""
    x = rng.normal(size=(2, 8, 8, 8, 60)).astype(np.float32)
    got, want = _run_both(
        lambda x: jnn.Inception3D(128, (3, 5), name="incep")(x, False, 0.0),
        lambda: tnn.Inception3D(60, 128, (3, 5)),
        x, rng,
    )
    assert got.shape == want.shape == (2, 8, 8, 8, 384)
    np.testing.assert_allclose(got, want, **TOL)


def test_backbone_flattens_ndhwc(rng):
    """run_backbone on TINY (ends at 4^3 x 24 on an 8^3 grid): the flatten
    order is NDHWC, which a channels-first flatten would scramble."""
    from nestinet_tpu_torch.models import backbones

    x = rng.normal(size=(2, 8, 8, 8, 20)).astype(np.float32)
    got, want = _run_both(
        lambda x: jnn.run_backbone(x, backbones.TINY, False, 0.0),
        lambda: tnn.Backbone(backbones.TINY, 20, 8),
        x, rng, rename=lambda p: p.replace("/", "."),
    )
    assert got.shape == want.shape == (2, 4 * 4 * 4 * 24)
    np.testing.assert_allclose(got, want, **TOL)
