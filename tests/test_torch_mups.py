"""The port's plain MuPS statistics against the JAX reference.

The same numpy inputs go through `nestinet_tpu.ops.mups.tdmfv_n_est` (jnp),
`tdmfv_n_est_pallas` (the Pallas kernel in interpret mode, as
tests/test_pallas_mups.py runs it) and the port's
`tdmfv_n_est_reference`, which is the CPU path of the port's `mups()` and
the oracle of its CUDA kernel.  Bars: atol 1e-5 forward and 1e-4 on the
gradient with respect to the points, the bars tests/test_pallas_mups.py
holds the Pallas kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu.ops.mups import mups as jax_mups
from nestinet_tpu.ops.mups import tdmfv_n_est
from nestinet_tpu.ops.pallas import mups_kernel
from nestinet_tpu_torch.ops import mups as torch_mups

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _gmm(m):
    return get_3d_grid_gmm([m, m, m], variance=(1.0 / m) ** 2).astuple()


def _case(rng, R, N, n_eff):
    """Points uniform in [-1, 1]^3 on the real rows, zeros on the padding."""
    pts = np.zeros((R, N, 3), np.float32)
    for r in range(R):
        real = min(int(n_eff[r]), N)
        pts[r, :real] = rng.uniform(-1, 1, size=(real, 3))
    return pts, np.asarray(n_eff, np.int32)


def _n_eff_cases(rng, R, N):
    return {
        "unpadded": np.full((R,), N, np.int32),
        "padded": rng.randint(4, N, size=(R,)),
        "zero": np.zeros((R,), np.int32),
        "last_row": np.full((R,), N - 1, np.int32),
        "mixed": np.array([0, N - 1, N, 3][:R], np.int32),
    }


def _port(pts, w, mu, sigma, n_eff):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return torch_mups.tdmfv_n_est_reference(
        t(pts), t(w), t(mu), t(sigma), t(n_eff)
    ).numpy()


@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("case", ["unpadded", "padded", "zero", "last_row", "mixed"])
def test_reference_matches_jax(rng, interpret_mode, m, case):
    R, N = 4, 48
    w, mu, sigma = _gmm(m)
    pts, n_eff = _case(rng, R, N, _n_eff_cases(rng, R, N)[case])
    got = _port(pts, w, mu, sigma, n_eff)
    want_jnp = np.asarray(
        tdmfv_n_est(jnp.asarray(pts), w, mu, sigma, jnp.asarray(n_eff), flatten=False)
    )
    want_pallas = np.asarray(
        mups_kernel.tdmfv_n_est_pallas(
            jnp.asarray(pts), jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sigma),
            jnp.asarray(n_eff),
        )
    )
    assert got.shape == want_jnp.shape == (R, 20, m ** 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_jnp, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5)


def test_masked_zeros_decide_max_min(rng):
    """Every real point lies below the centre Gaussian on all three axes,
    so its real q*s values are all < 0 and the mu max comes only from the
    masked rows' zeros.  A reduction that skips masked rows would return
    the largest negative value instead, far outside the bar."""
    w, mu, sigma = _gmm(3)
    N = 32
    pts = np.zeros((1, N, 3), np.float32)
    n_eff = np.array([9], np.int32)  # rows 0..9 real, 10..31 masked
    pts[0, :10] = rng.uniform(-0.3, -0.05, size=(10, 3))
    got = _port(pts, w, mu, sigma, n_eff)
    want = np.asarray(
        tdmfv_n_est(jnp.asarray(pts), w, mu, sigma, jnp.asarray(n_eff), flatten=False)
    )
    np.testing.assert_allclose(got, want, atol=1e-5)
    k = 13  # the Gaussian at the origin
    assert np.all(got[0, 2:5, k] == 0.0)  # mu_max xyz: the masked zeros
    assert np.all(got[0, 5:8, k] < -1e-2)  # mu_min xyz: the real rows
    # the same real rows without padding take a clearly negative max
    dense = _port(pts[:, :10], w, mu, sigma, np.array([10], np.int32))
    assert np.all(dense[0, 2:5, k] < -1e-2)


@pytest.mark.parametrize("pad", [False, True])
def test_gradient_through_function_matches_jax(rng, pad):
    """Gradient with respect to the points through the port's
    autograd.Function (CPU: plain forward, backward by autograd through
    the plain version) against jax.grad of the jnp reference."""
    import jax

    R, N = 2, 32
    w, mu, sigma = _gmm(3)
    n_eff = rng.randint(4, N, size=(R,)) if pad else np.full((R,), N)
    pts, n_eff = _case(rng, R, N, n_eff)

    def loss_ref(p):
        out = tdmfv_n_est(p, w, mu, sigma, jnp.asarray(n_eff), flatten=False)
        return jnp.sum(out ** 2 * jnp.arange(20.0)[None, :, None])

    want = np.asarray(jax.grad(loss_ref)(jnp.asarray(pts)))

    p = torch.from_numpy(pts).requires_grad_(True)
    out = torch_mups.tdmfv_n_est(
        p, torch.from_numpy(w), torch.from_numpy(mu), torch.from_numpy(sigma),
        torch.from_numpy(n_eff),
    )
    loss = torch.sum(out ** 2 * torch.arange(20.0)[None, :, None])
    loss.backward()
    if not pad:
        assert np.isfinite(want).all()
    # Padded rows can leave a statistic at exactly 0, where the signed
    # square root has no derivative: both packages give NaN there, and
    # assert_allclose requires the NaNs at the same places.
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4)


def test_mups_grid_layout_matches_jax(rng):
    """mups() over S=3 scales: [B, r, r, r, 20*S] with channel s*20 + c,
    against JAX mups(..., impl="jnp")."""
    m, S, B, N = 3, 3, 2, 24
    w, mu, sigma = _gmm(m)
    n_eff = rng.randint(0, N, size=(B, S)).astype(np.int32)
    n_eff[0, 1] = 0
    pts = rng.uniform(-1, 1, size=(B, S * N, 3)).astype(np.float32)
    for b in range(B):
        for s in range(S):
            pts[b, s * N + n_eff[b, s] + 1 : (s + 1) * N] = 0.0
    want = np.asarray(
        jax_mups(jnp.asarray(pts), jnp.asarray(n_eff), w, mu, sigma,
                 n_scales=S, resolution=m, impl="jnp")
    )
    got = torch_mups.mups(
        torch.from_numpy(pts), torch.from_numpy(n_eff), torch.from_numpy(w),
        torch.from_numpy(mu), torch.from_numpy(sigma), n_scales=S, resolution=m,
    ).numpy()
    assert got.shape == want.shape == (B, m, m, m, 20 * S)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: a CPU tensor raises
    before anything is built."""
    from nestinet_tpu_torch.ops.kernels import mups_cuda

    w, mu, sigma = (torch.from_numpy(a) for a in _gmm(3))
    with pytest.raises(ValueError, match="CUDA"):
        mups_cuda.tdmfv_n_est_cuda(
            torch.zeros(2, 8, 3), w, mu, sigma, torch.zeros(2, dtype=torch.int32)
        )
    assert mups_cuda.KERNEL.launches == {"tdmfv_n_est": 0, "tdmfv_n_est_blocked": 0}
