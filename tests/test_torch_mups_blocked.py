"""The port's blocked-MuPS entry point against the JAX experiment's, on
the CPU.

`nestinet_tpu_torch.scripts.mups_kernel_exp.forward_blocked` (on a CPU
tensor: the plain `tdmfv_n_est_reference`) against `forward_blocked` of
`scripts/mups_kernel_exp.py`, the Pallas `_kernel_blocked` run in interpret
mode as tests/test_pallas_mups.py runs the shipped kernel.  B = 4 rows,
N = 64 points, a 4^3 GMM, block_b in {1, 2, 4}, padded and unpadded rows;
bar atol 1e-5, the bar of tests/test_pallas_mups.py:55.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu_torch.scripts import mups_kernel_exp
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts", "mups_kernel_exp.py")


@pytest.fixture(scope="module")
def jax_exp():
    spec = importlib.util.spec_from_file_location("jax_mups_kernel_exp", _SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(rng, padded: bool):
    B, N = 4, 64
    w, mu, sigma = get_3d_grid_gmm([4, 4, 4], variance=(1.0 / 4) ** 2).astuple()
    pts = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    n_eff = np.full((B,), N, np.int32)
    if padded:
        n_eff = np.array([0, 5, N - 1, 31], np.int32)
        for b in range(B):
            pts[b, n_eff[b] + 1:] = 0.0
    return pts, w, mu, sigma, n_eff


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("block_b", [1, 2, 4])
def test_forward_blocked_matches_jax(rng, jax_exp, interpret_mode, block_b, padded):
    pts, w, mu, sigma, n_eff = _inputs(rng, padded)
    want = np.asarray(jax_exp.forward_blocked(
        jnp.asarray(pts), jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sigma),
        jnp.asarray(n_eff), block_b,
    ))
    t = torch.from_numpy
    got = mups_kernel_exp.forward_blocked(t(pts), t(w), t(mu), t(sigma), t(n_eff), block_b)
    assert got.shape == want.shape == (4, 20, 64)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("block_b", [3, 0])
def test_forward_blocked_raises_when_rows_do_not_divide(rng, block_b):
    pts, w, mu, sigma, n_eff = (torch.from_numpy(a) for a in _inputs(rng, False))
    with pytest.raises(ValueError, match="divide"):
        mups_kernel_exp.forward_blocked(pts, w, mu, sigma, n_eff, block_b)


def test_blocked_cuda_wrapper_refuses_cpu_tensors(rng):
    """The blocked kernel's wrapper never computes on the CPU."""
    from nestinet_tpu_torch.ops.kernels import mups_cuda

    pts, w, mu, sigma, n_eff = (torch.from_numpy(a) for a in _inputs(rng, False))
    with pytest.raises(ValueError, match="CUDA"):
        mups_cuda.tdmfv_n_est_blocked_cuda(pts, w, mu, sigma, n_eff, 2)
    assert mups_cuda.KERNEL.launches["tdmfv_n_est_blocked"] == 0


def test_main_needs_a_gpu():
    """The timing entry point measures on the card only."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mups_kernel_exp.main(["--batch", "8", "--n", "16", "--blocks", "1"])
