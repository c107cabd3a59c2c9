"""The port's 3DmFV variants, NumPy Fisher-vector helpers and grid GMMs
against the JAX package's, on the CPU.

No model of either package calls the variants (`tdmfv_classification`,
`tdmfv_sym`, `fv`, `tdmfv_seg`, `nestinet_tpu/ops/mups.py:214-381`) and no
TPU kernel stands behind them: the port's are plain tensor functions.  The
same seeded points go through both on 3^3 and 8^3 grids, flattened and
not, `fv` normalized and not.  Bars: atol 1e-5 forward, and 1e-4 on
`tdmfv_classification`'s gradient with respect to the points, the bars
`tests/test_pallas_mups.py:55,74` hold the Pallas kernel to.  The NumPy
helpers and the GMMs are the same NumPy code, so they must be identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.ops import gmm as jax_gmm
from nestinet_tpu_torch.ops import gmm
from nestinet_tpu_torch.ops import mups

jax_mups = importlib.import_module("nestinet_tpu.ops.mups")  # `ops.mups` is a function

torch.set_num_threads(1)

VARIANTS = {  # name -> (function name, keyword arguments)
    "tdmfv_classification": ("tdmfv_classification", {}),
    "tdmfv_sym_max": ("tdmfv_sym", {"sym_type": "max"}),
    "tdmfv_sym_min": ("tdmfv_sym", {"sym_type": "min"}),
    "tdmfv_sym_ss": ("tdmfv_sym", {"sym_type": "ss"}),
    "fv": ("fv", {}),
    "fv_unnormalized": ("fv", {"normalize": False}),
    "tdmfv_seg": ("tdmfv_seg", {}),
}


def _case(m, seed, B=3, N=64):
    rng = np.random.RandomState(seed)
    w, mu, sigma = jax_gmm.get_3d_grid_gmm([m] * 3, variance=(1.0 / m) ** 2).astuple()
    points = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    return points, w, mu, sigma


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_equals_jax(variant, m, flatten):
    fn, kw = VARIANTS[variant]
    for seed in range(3):
        points, w, mu, sigma = _case(m, seed)
        want = getattr(jax_mups, fn)(jnp.asarray(points), w, mu, sigma, flatten=flatten, **kw)
        got = getattr(mups, fn)(*_t(points, w, mu, sigma), flatten=flatten, **kw)
        if variant == "tdmfv_seg":  # (fv, fv_per_point)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
            got, want = got[0], want[0]
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_variant_layout():
    """Channels per Gaussian: 20 for the max/min/sum statistics, 7 for one
    symmetric function or the sums; channel-major when flattened."""
    points, w, mu, sigma = _t(*_case(3, 0))
    K = mu.shape[0]
    assert mups.tdmfv_classification(points, w, mu, sigma).shape == (3, 20 * K)
    assert mups.tdmfv_sym(points, w, mu, sigma, flatten=False).shape == (3, 7, K)
    assert mups.fv(points, w, mu, sigma).shape == (3, 7 * K)
    out, per_point = mups.tdmfv_seg(points, w, mu, sigma)
    assert out.shape == (3, 20 * K) and per_point.shape == (3, 64, 7 * K)
    flat = mups.tdmfv_classification(points, w, mu, sigma)
    grid = mups.tdmfv_classification(points, w, mu, sigma, flatten=False)
    torch.testing.assert_close(flat, grid.reshape(3, -1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sym_type"):
        mups.tdmfv_sym(points, w, mu, sigma, sym_type="mean")


def test_classification_gradient_equals_jax():
    points, w, mu, sigma = _case(3, 11, B=2, N=32)
    weights = np.random.RandomState(12).normal(size=(2, 20 * 27)).astype(np.float32)

    def jax_loss(p):
        return jnp.sum(jax_mups.tdmfv_classification(p, w, mu, sigma) * weights)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(points)))
    p = torch.from_numpy(points).requires_grad_(True)
    loss = torch.sum(mups.tdmfv_classification(p, *_t(w, mu, sigma)) * torch.from_numpy(weights))
    (got,) = torch.autograd.grad(loss, p)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("normalization", [True, False])
def test_numpy_helpers_equal_jax(normalization):
    rng = np.random.RandomState(13)
    xx = rng.uniform(-1, 1, (200, 3))
    g_port = gmm.get_3d_grid_gmm([3, 3, 3], variance=0.1)
    g_jax = jax_gmm.get_3d_grid_gmm([3, 3, 3], variance=0.1)
    np.testing.assert_array_equal(mups.soft_assignment_np(xx, g_port),
                                  jax_mups.soft_assignment_np(xx, g_jax))
    np.testing.assert_array_equal(mups.fisher_vector_np(xx, g_port, normalization),
                                  jax_mups.fisher_vector_np(xx, g_jax, normalization))
    for got, want in zip(mups.fisher_vector_per_point_np(xx, g_port),
                         jax_mups.fisher_vector_per_point_np(xx, g_jax)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim,n", [(2, 4), (3, 5), (2, [3, 6]), (3, [2, 3, 4])])
def test_grid_gmms_equal_jax(dim, n):
    got = gmm.get_gmm(None, n, type="grid", variance=0.05, dim=dim)
    want = jax_gmm.get_gmm(None, n, type="grid", variance=0.05, dim=dim)
    for field in ("weights", "means", "covariances"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    if dim == 2:
        two = gmm.get_2d_grid_gmm(n if isinstance(n, list) else [n, n], variance=0.05)
        np.testing.assert_array_equal(two.means, want.means)


def test_learned_and_unknown_gmms_raise():
    points = np.random.RandomState(0).uniform(-1, 1, (50, 3))
    with pytest.raises(NotImplementedError, match="item 6"):
        gmm.get_gmm(points, 4, type="learn")
    with pytest.raises(ValueError, match="unknown GMM type"):
        gmm.get_gmm(points, 4, type="kmeans")
    with pytest.raises(ValueError, match="dim 2 or 3"):
        gmm.get_gmm(None, 4, dim=4)
