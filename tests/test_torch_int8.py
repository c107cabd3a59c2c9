"""int8 serving ops of the port (`ops/quant.py`) against the JAX package.

  * weights: the port's int8 kernels and per-cout scales equal
    `quantize_params_np`'s, bit for bit, on a whole tiny flagship tree;
  * `conv3d_int8` / `linear_int8` against JAX's `conv_nd_int8` /
    `linear_int8` on identical bfloat16 inputs, at the flagship's odd
    widths (cin 42 -> cout 21, FC cout 7 and 3) and even kernels: the
    int8 MACs are integer work, so at most one bfloat16 ulp on at most
    0.1% of the elements (XLA may contract the epilogue into an FMA);
  * the plain kernel twin is an exact integer conv, held to a NumPy int64
    one, asymmetric SAME padding included;
  * the activation scale and the ActQ bounds the blocks forward;
  * the CUDA wrapper refuses CPU tensors (the kernel itself is held to the
    plain version on the card by `chip_smoke.py`).
"""

import dataclasses

import haiku as hk
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.ops import nn as jnn
from nestinet_tpu.ops import quant as jquant
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops import quant
from nestinet_tpu_torch.ops.kernels import int8_cuda

from .test_torch_dtypes import assert_bf16_close, to_f32

torch.set_num_threads(1)

DIMS3 = ("NDHWC", "DHWIO", "NDHWC")


def unpack_conv(w_q: torch.Tensor, cin: int, k: int) -> np.ndarray:
    """The port's packed [cout, k^3, cin_p] kernel -> DHWIO, as JAX keeps it."""
    cout = w_q.shape[0]
    return w_q[..., :cin].reshape(cout, k, k, k, cin).permute(1, 2, 3, 4, 0).numpy()


def test_weight_quantization_equals_jax():
    """Every conv and linear of a tiny flagship (stacked expert groups
    included): int8 kernel and scales identical to `quantize_params_np`."""
    from nestinet_tpu.models import build_model as jax_build_model
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm

    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import GridGMM

    from .test_torch_experts import tiny_cfg

    cfg = tiny_cfg(num_gaussians=3, gmm_variance=1.0 / 9)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    batch = {"points": np.zeros((2, 48, 3), np.float32), "n_eff": np.full((2, 3), 16, np.int32)}
    params, state = jax.device_get(jax_build_model(cfg, gmm).init(jax.random.PRNGKey(2), batch))
    q = jquant.quantize_params_np(params)

    # the JAX int8 kernels (as floats) where the weights were, the scales
    # where the biases were, carried into torch paths by the converter
    def swap(tree, pick):
        if not isinstance(tree, dict):
            return tree
        if "w_scale" in tree:
            return {"w": pick(tree).astype(np.float32), "b": tree["w_scale"]}
        return {k: swap(v, pick) for k, v in tree.items()}

    sd_q = convert.from_haiku(swap(q, lambda t: t["w"]), state, cfg)

    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    quant.quantize_(model)
    n = 0
    for name, m in model.named_modules():
        if isinstance(m, (tnn._Conv3D, tnn._Linear)):
            want_w, want_s = sd_q[name + ".w"].numpy(), sd_q[name + ".b"].numpy()
            if isinstance(m, tnn._Conv3D):
                got = unpack_conv(m.w_q, want_w.shape[1], m.kernel).transpose(4, 3, 0, 1, 2)
            else:
                got = m.w_q[:, 0, : want_w.shape[1]].numpy()
            assert m.w_q.dtype == torch.int8 and m.w is None
            np.testing.assert_array_equal(got.astype(np.float32), want_w, err_msg=name)
            np.testing.assert_array_equal(m.w_scale.numpy(), want_s, err_msg=name)
            n += 1
    assert n == 8 * 8  # manager + 7 experts, 4 convs + 4 FC layers each


def _conv_case(rng, cin, cout, k, size=(2, 5, 6, 7)):
    x = jnp.asarray(rng.normal(size=size + (cin,)) * 2).astype(jnp.bfloat16)
    w = (rng.normal(size=(k, k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("cin,cout,k", [
    (6, 8, 1), (6, 8, 2), (6, 8, 3), (6, 8, 4), (6, 8, 5),
    (42, 21, 3), (42, 21, 5), (60, 42, 1), (20, 16, 4),
])
@pytest.mark.parametrize("bound", [False, True])
def test_conv3d_int8_matches_jax(rng, cin, cout, k, bound):
    x, w, b = _conv_case(rng, cin, cout, k)
    amax = None
    if bound:  # a forwarded bound above max|x|, as an average pool keeps
        amax = jnp.max(jnp.abs(x)).astype(jnp.float32) * 1.5
    want = jquant.conv_nd_int8(x, jnp.asarray(w), jnp.asarray(b), window_strides=(1, 1, 1),
                               dimension_numbers=DIMS3, x_amax=amax)
    xt = torch.from_numpy(to_f32(x)).to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    w_q, s_w = quant.quantize_weight(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
    got = quant.conv3d_int8(xt, w_q, s_w, torch.from_numpy(b), k,
                            None if amax is None else torch.tensor(float(amax)))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(to_f32(got).transpose(0, 2, 3, 4, 1), want, max_frac=1e-3)


@pytest.mark.parametrize("cin,cout,B", [(128, 7, 37), (64, 3, 256), (1536, 64, 5), (24, 16, 4)])
def test_linear_int8_matches_jax(rng, cin, cout, B):
    x = jnp.asarray(rng.normal(size=(B, cin))).astype(jnp.bfloat16)
    w = (rng.normal(size=(cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    want = jquant.linear_int8(x, jnp.asarray(w), jnp.asarray(b))
    w_q, s_w = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    got = quant.linear_int8(torch.from_numpy(to_f32(x)).to(torch.bfloat16), w_q, s_w,
                            torch.from_numpy(b))
    assert got.shape == (B, cout) and got.dtype == torch.bfloat16
    assert_bf16_close(got, want, max_frac=1e-3)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_reference_is_an_exact_integer_conv(rng, k):
    """The kernel's plain twin: int64 sums by NumPy over the SAME window
    (the odd cell of an even kernel's padding at the end), then the float32
    epilogue float(acc) * (s_w * s_x) + b and one rounding to bfloat16."""
    B, D, H, W, cin, cout = 2, 4, 5, 3, 20, 7
    cin_p = quant.padded_channels(cin)
    x = np.zeros((B, D, H, W, cin_p), np.int8)
    x[..., :cin] = rng.randint(-127, 128, size=(B, D, H, W, cin))
    w = np.zeros((cout, k ** 3, cin_p), np.int8)
    w[..., :cin] = rng.randint(-127, 128, size=(cout, k ** 3, cin))
    s_w = rng.uniform(1e-3, 2e-3, cout).astype(np.float32)
    s_x = np.float32(rng.uniform(1e-2, 2e-2))
    b = rng.normal(size=cout).astype(np.float32)

    lo = (k - 1) // 2
    xp = np.pad(x.astype(np.int64), ((0, 0), (lo, k - 1 - lo), (lo, k - 1 - lo),
                                     (lo, k - 1 - lo), (0, 0)))
    acc = np.zeros((B, D, H, W, cout), np.int64)
    wk = w.astype(np.int64).reshape(cout, k, k, k, cin_p)
    for a in range(k):
        for c in range(k):
            for e in range(k):
                acc += np.einsum("bdhwi,oi->bdhwo", xp[:, a:a + D, c:c + H, e:e + W],
                                 wk[:, a, c, e])
    want = acc.astype(np.float32) * (s_w * s_x) + b
    want = torch.from_numpy(want.transpose(0, 4, 1, 2, 3).copy()).to(torch.bfloat16)
    got = quant.int8_conv3d_reference(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(s_w), torch.tensor(s_x),
                                      torch.from_numpy(b), k)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_activation_quantization_divides(rng):
    """round(x / s_x), clipped, never x * (1 / s_x); channels last and
    zero-padded to a multiple of 16."""
    x = torch.from_numpy((rng.normal(size=(3, 20, 2, 3, 4)) * 5).astype(np.float32))
    x = x.to(torch.bfloat16)
    s_x = quant.activation_scale(x)
    assert s_x.dtype == torch.float32 and s_x.dim() == 0
    xf = x.float().numpy()
    want_s = np.float32(max(np.abs(xf).max(), np.float32(1e-12))) / np.float32(127.0)
    assert s_x.item() == want_s
    q = quant.quantize_activation(x, s_x)
    assert q.dtype == torch.int8 and q.shape == (3, 2, 3, 4, 32)
    want = np.clip(np.round(xf / want_s), -127, 127).transpose(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(q[..., :20].numpy(), want)
    assert not q[..., 20:].any()
    assert q.abs().max() == 127
    # a bound forwarded by the producer sets the scale instead
    bound = torch.tensor(2.0 * np.abs(xf).max())
    assert quant.activation_scale(x, bound).item() == np.float32(bound.item()) / np.float32(127)


def test_blocks_forward_their_bounds(rng):
    """Quantized ConvBN3D emits max|out| of what it returns (pre-ReLU,
    negatives included, when relu=False); the Inception concat takes the
    max over its branches; the backbone flatten hands its bound to FC1,
    and DenseBN returns a plain tensor."""
    block = tnn.Inception3D(24, 8, (3, 5))
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.3)
    quant.quantize_(block.eval())
    x = torch.from_numpy(rng.normal(size=(2, 24, 4, 4, 4)).astype(np.float32))
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        one = block.conv1(x)
        pre = block.conv4(x, relu=False)
        out = block(x)
    for a in (one, pre, out):
        assert isinstance(a, tnn.ActQ) and a.amax.dtype == torch.float32
        assert a.amax.item() == a.x.abs().max().float().item()
    assert (pre.x < 0).any()
    assert out.amax.item() >= out.x.abs().max().float().item()

    from nestinet_tpu_torch.models import backbones

    net = tnn.Backbone(backbones.TINY, 20, 4)
    head = tnn.DenseBN(net.out_features, 5, bn=True)
    for p in list(net.parameters()) + list(head.parameters()):
        torch.nn.init.normal_(p, std=0.3)
    quant.quantize_(net.eval())
    quant.quantize_(head.eval())
    g = torch.from_numpy(rng.normal(size=(3, 20, 4, 4, 4)).astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        feat = net(g)
        y = head(feat)
    assert isinstance(feat, tnn.ActQ) and feat.x.shape == (3, net.out_features)
    assert isinstance(y, torch.Tensor) and not isinstance(y, tnn.ActQ)


def test_the_first_conv_reduces_its_own_input(rng):
    """A plain tensor (the grid) has no bound: the conv quantizes with
    max|x| of its own input, as JAX's `_quantize_tensor`."""
    x, w, b = _conv_case(rng, 20, 8, 1)
    want = jquant.conv_nd_int8(x, jnp.asarray(w), jnp.asarray(b), window_strides=(1, 1, 1),
                               dimension_numbers=DIMS3)
    conv = tnn._Conv3D(20, 8, 1)
    conv.load_state_dict({"w": torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()),
                          "b": torch.from_numpy(b)})
    conv.quantize_()
    got = conv(torch.from_numpy(to_f32(x)).to(torch.bfloat16).permute(0, 4, 1, 2, 3))
    assert_bf16_close(to_f32(got).transpose(0, 2, 3, 4, 1), want, max_frac=1e-3)


def test_int8_takes_bfloat16_only_and_quantizes_once():
    conv = tnn._Conv3D(4, 4, 1)
    torch.nn.init.normal_(conv.w)
    quant.quantize_(conv)
    with pytest.raises(TypeError, match="bfloat16"):
        conv(torch.zeros((1, 4, 2, 2, 2)))
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_(conv)


def test_cuda_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the serving op takes the plain version; the kernel's
    own wrapper never does, and counts no launch."""
    x_q = torch.zeros((1, 2, 2, 2, 16), dtype=torch.int8)
    w_q = torch.zeros((4, 1, 16), dtype=torch.int8)
    args = (x_q, w_q, torch.ones(4), torch.tensor(1.0), torch.zeros(4))
    before = dict(int8_cuda.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        int8_cuda.int8_conv3d_cuda(*args, 1)
    assert quant.int8_conv3d(*args, 1).shape == (1, 4, 2, 2, 2)
    assert int8_cuda.KERNEL.launches == before == {"int8_conv3d": 0}


def test_quantized_model_serves_with_the_same_manager_batch(rng):
    """Routed against dense under int8: the manager sees the same batch,
    so its probabilities are identical; a routed expert quantizes its own
    sub-batch, so its normals may move, within a bfloat16-scale bound."""
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm

    from nestinet_tpu_torch.infer.predict import route_sparse
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.models.base import init_params
    from nestinet_tpu_torch.ops.gmm import GridGMM

    from .test_torch_experts import tiny_cfg

    cfg = dataclasses.replace(tiny_cfg(num_gaussians=3, gmm_variance=1.0 / 9),
                              compute_dtype="int8")
    g = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    model = build_model(cfg, GridGMM(g.weights, g.means, g.covariances))
    init_params(model, torch.Generator().manual_seed(0))
    quant.quantize_(model.eval())
    points = torch.from_numpy(rng.uniform(-1, 1, (12, 48, 3)).astype(np.float32))
    n_eff = torch.full((12, 3), 16, dtype=torch.int32)
    with torch.inference_mode():
        grid = model.mups_grid(points, n_eff)
        assert grid.dtype == torch.bfloat16
        normals, ids, probs = route_sparse(model, grid, 12)
        out = model.forward_grid(grid)
    torch.testing.assert_close(probs, out["experts_prob"].t(), rtol=0, atol=0)
    torch.testing.assert_close(ids, out["experts_prob"].argmax(0), rtol=0, atol=0)
    assert normals.dtype == torch.float32 and torch.isfinite(normals).all()
