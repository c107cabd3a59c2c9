"""BatchNorm folding of the port (`ops/fold.py`) against the JAX package.

The port folds on its module tree in float32 torch ops on the tensors'
device, JAX on the haiku trees in NumPy float32 on the host
(`fold_bn_params_np`).  Bars: every
folded kernel and bias within atol 1e-6 of JAX's after the layout map;
a folded float32 model within atol 1e-4 of the
unfolded one (float reassociation only); the all-or-nothing contract
raises where JAX's does.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from nestinet_tpu.ops import fold as jfold
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.fold import fold_bn_
from nestinet_tpu_torch.ops.quant import quantize_

from .test_torch_experts import random_bn, tiny_cfg
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    """A tiny flagship's haiku trees with random BatchNorm state, its port,
    and a batch."""
    from nestinet_tpu.models import build_model as jax_build_model
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm

    from nestinet_tpu_torch.ops.gmm import GridGMM

    rng = np.random.RandomState(11)
    cfg = tiny_cfg(num_gaussians=3, gmm_variance=1.0 / 9)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    batch = {"points": rng.uniform(-1, 1, (6, 48, 3)).astype(np.float32),
             "n_eff": rng.randint(0, 17, (6, 3)).astype(np.int32)}
    params, state = jax.device_get(jax_build_model(cfg, gmm).init(jax.random.PRNGKey(4), batch))
    params, state = random_bn(params, state, rng)
    return cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances), params, state, batch


def port_model(cfg, gmm, params, state):
    from nestinet_tpu_torch.models import build_model

    model = build_model(cfg, gmm)
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    return model.eval()


def test_folded_kernels_equal_jax(flagship):
    cfg, gmm, params, state, _ = flagship
    fp, fs = jfold.fold_bn_params_np(params, state)
    assert jfold.folded_param_tree(fp)
    want = convert.from_haiku(fp, fs, cfg)  # conv/linear entries only
    model = fold_bn_(port_model(cfg, gmm, params, state))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)
    assert not any(isinstance(m, tnn.BatchNormEMA) for m in model.modules())


def test_folded_model_matches_unfolded(flagship):
    cfg, gmm, params, state, batch = flagship
    points, n_eff = torch.from_numpy(batch["points"]), torch.from_numpy(batch["n_eff"])
    with torch.inference_mode():
        want = port_model(cfg, gmm, params, state)(points, n_eff)
        got = fold_bn_(port_model(cfg, gmm, params, state))(points, n_eff)
    for key in ("n_pred", "experts_prob"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-4)


def test_fold_refuses_a_quantized_kernel():
    block = tnn.ConvBN3D(4, 8, 3)
    torch.nn.init.normal_(block.conv.w)
    quantize_(block)
    with pytest.raises(ValueError, match="fold BN before int8"):
        fold_bn_(block)


@pytest.mark.parametrize("layout", ["no_sibling", "other_name"])
def test_fold_refuses_a_bn_without_an_affine_sibling(layout):
    """All or nothing: a BN the fold cannot reach raises rather than stay
    behind in a model served as folded."""
    if layout == "no_sibling":
        model = nn.Module()
        model.bn = tnn.BatchNormEMA(4)
    else:
        model = tnn.ConvBN3D(4, 4, 1)
        model.norm = tnn.BatchNormEMA(4)
    with pytest.raises(ValueError, match="no conv/linear sibling"):
        fold_bn_(model)
