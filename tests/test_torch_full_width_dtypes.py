"""The flagship manager CNN at full width (`CONV_NET_8G` + FC
1024/256/128/7 on a [B, 8, 8, 8, 60] grid, every Inception block after the
first with cin > n) in float32, bfloat16 and int8, against JAX run eagerly
on the same weights and random BatchNorm state.

Bars, with what was measured on a 4-patch batch in brackets: float32
within 1e-4 [3e-7]; int8 within one bfloat16 ulp on 0.1% of the logits
[identical: its MACs are integer work]; bfloat16 within 2% of the largest
logit [0.7%: the bfloat16 convs sum in another order than XLA's and a
rounding that falls otherwise travels through 21 layers; JAX's own
bfloat16 differs from its float32 by 0.5%].
"""

import haiku as hk
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.models import backbones as jax_backbones
from nestinet_tpu.models.base import fc_head
from nestinet_tpu.ops import nn as jnn
from nestinet_tpu.ops import quant as jquant
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.models.base import ConvNet
from nestinet_tpu_torch.ops.quant import quantize_

from .test_torch_dtypes import assert_bf16_close, to_f32
from .test_torch_experts import random_bn
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def manager():
    rng = np.random.RandomState(0)
    x = np.abs(rng.normal(size=(4, 8, 8, 8, 60))).astype(np.float32)

    def fwd(x):
        feat = jnn.run_backbone(x, jax_backbones.CONV_NET_8G, False, 0.0)
        return fc_head(feat, (1024, 256, 128), 7, is_training=False, bn_momentum=0.0,
                       final_activation=jax.nn.relu)

    f = hk.transform_with_state(fwd)
    params, state = f.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, state = random_bn({"m": params}, {"m": state}, rng)
    return f, params["m"], state["m"], x


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_full_width_manager_matches_jax(manager, mode):
    f, params, state, x = manager
    dtype = jnp.float32 if mode == "float32" else jnp.bfloat16
    with jquant.quantized(mode == "int8"):
        want, _ = f.apply(params, state, None, jnp.asarray(x).astype(dtype))
    want = to_f32(want)

    net = ConvNet(jax_backbones.CONV_NET_8G, 60, 8, (1024, 256, 128), 7, final_activation="relu")
    net.load_state_dict(convert.module_to_torch(params, state, convert.net_path))
    net.eval()
    if mode == "int8":
        quantize_(net)
    xt = torch.from_numpy(x).to(torch.float32 if mode == "float32" else torch.bfloat16)
    with torch.inference_mode():
        got = to_f32(net(xt.permute(0, 4, 1, 2, 3)))
    assert got.shape == (4, 7) and np.abs(want).max() > 0.1
    if mode == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    elif mode == "int8":
        assert_bf16_close(got, want, max_frac=1e-3)
    else:
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
