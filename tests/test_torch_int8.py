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
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

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
    zero-padded to the packed width (20 -> 32)."""
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
    x = torch.zeros((1, 16, 2, 2, 2), dtype=torch.bfloat16)
    w_q = torch.zeros((4, 1, 16), dtype=torch.int8)
    args = (x, w_q, torch.ones(4), torch.zeros(4), 1)
    before = dict(int8_cuda.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        int8_cuda.int8_conv3d_cuda(*args, torch.tensor(1.0))
    y, amax = quant.int8_conv3d_fused(*args, torch.tensor(1.0), want_amax=True)
    assert y.shape == (1, 4, 2, 2, 2) and amax.item() == 0.0
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


# ---- the fused kernel's plain version and the kernel's own arithmetic ----


def _bf16_case(rng, B, cin, r, scale=2.0):
    x = torch.from_numpy((rng.normal(size=(B, cin, r, r, r)) * scale).astype(np.float32))
    return x.to(torch.bfloat16)


def _packed_weights(rng, cin, cout, k):
    w = torch.from_numpy((rng.normal(size=(cout, cin, k, k, k)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    w_q, s_w = quant.quantize_weight(w)
    return w_q, s_w, b


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_fused_reference_equals_the_unfused_sequence(rng, k, bound, relu):
    """activation_scale + quantize_activation + int8_conv3d_reference (+
    ReLU), bit for bit, and its amax is max|y| of what it returns."""
    x = _bf16_case(rng, 2, 20, 4)
    w_q, s_w, b = _packed_weights(rng, 20, 12, k)
    x_amax = x.abs().amax().float() * 1.25 if bound else None
    y, amax = quant.int8_conv3d_fused_reference(x, w_q, s_w, b, k, x_amax, relu=relu,
                                                want_amax=True)
    s_x = quant.activation_scale(x, x_amax)
    want = quant.int8_conv3d_reference(quant.quantize_activation(x, s_x), w_q, s_w, s_x, b, k)
    if relu:
        want = torch.nn.functional.relu(want)
        assert (y >= 0).all()
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)
    assert amax.dtype == torch.float32 and amax.item() == want.abs().amax().float().item()
    y2, none = quant.int8_conv3d_fused(x, w_q, s_w, b, k, x_amax, relu=relu)
    assert none is None and torch.equal(y2, y)


def test_folded_convbn_is_one_fused_call(rng):
    """With BN folded (an identity), a quantized ConvBN3D returns exactly
    the fused version's output and bound, ReLU on and off."""
    from nestinet_tpu_torch.ops.fold import fold_bn_

    blk = tnn.ConvBN3D(20, 12, 3)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.3)
    quant.quantize_(fold_bn_(blk.eval()))
    assert isinstance(blk.bn, torch.nn.Identity)
    x = _bf16_case(rng, 2, 20, 4)
    c = blk.conv
    for relu in (True, False):
        got = blk(x, relu=relu)
        want = quant.int8_conv3d_fused_reference(x, c.w_q, c.w_scale, c.b, 3, relu=relu,
                                                 want_amax=True)
        assert isinstance(got, tnn.ActQ)
        assert torch.equal(got.x, want[0]) and torch.equal(got.amax, want[1])


@pytest.mark.parametrize("cin", [6, 16, 20, 42, 60, 64, 126, 128, 256, 384, 768, 1536])
def test_packed_widths_fit_the_kernel(cin):
    cin_p = quant.padded_channels(cin)
    assert int8_cuda.valid_cin_p(cin_p) and cin <= cin_p
    assert cin_p - cin < (16 if cin <= 16 else cin if cin <= 64 else 128)


@pytest.mark.parametrize("M,cout,want", [
    (131072, 128, (128, 128)), (131072, 21, (128, 32)), (131072, 42, (128, 64)),
    (37 * 512, 128, (128, 128)), (37 * 64, 256, (64, 64)), (37 * 8, 512, (64, 32)),
    (256, 1024, (64, 32)), (37, 1024, (64, 32)), (37, 3, (64, 32)), (256, 7, (64, 32)),
])
def test_tile_shape_fills_the_card_from_the_shape(M, cout, want):
    sms = 132  # an H100 SXM
    bm, bn = int8_cuda.tile_shape(M, cout, sms)
    assert (bm, bn) == want
    blocks = -(-M // bm) * -(-cout // bn)
    assert blocks >= sms or (bm, bn) == (64, 32)


def _kernel_quantize(v, s_x):
    """The kernel's quantize, in float32: the reciprocal's product clamped to
    [-128, 128], rounded half to even by adding and subtracting 1.5 * 2^23,
    and the exact quotient only within 2^-14 of a tie."""
    f32 = np.float32
    inv = f32(1) / s_x
    p = np.clip((v * inv).astype(f32), f32(-128), f32(128))
    t = (p + f32(12582912.0)).astype(f32)
    r = (t - f32(12582912.0)).astype(f32)
    near = np.abs((p - r).astype(f32)) > f32(0.5) - f32(2.0 ** -14)
    q = np.clip(t.view(np.int32) - 0x4B400000, -127, 127).astype(f32)
    exact = np.clip(np.rint((v / s_x).astype(f32)), -127, 127)
    return np.where(near, exact, q)


@pytest.mark.parametrize("seed", range(4))
def test_kernel_quantize_equals_the_division(seed):
    """rint(x * (1/s)) with the tie guard equals rint(x / s) everywhere,
    including values built to sit next to the ties k + 0.5 and a bound of
    exactly twice a value (x / s = 63.5 up to the rounding of s)."""
    rng = np.random.RandomState(seed)
    amax = np.float32(rng.uniform(1e-3, 30.0))
    s_x = np.float32(max(amax, np.float32(1e-12))) / np.float32(127)
    v = rng.uniform(-1.0, 1.0, 200000).astype(np.float32) * amax
    ties = (rng.randint(-127, 127, 50000) + np.float32(0.5)).astype(np.float32) * s_x
    for d in range(-3, 4):
        t = ties.copy()
        for _ in range(abs(d)):
            t = np.nextafter(t, np.float32(np.inf) if d > 0 else np.float32(-np.inf))
        v = np.concatenate([v, t.astype(np.float32)])
    half = np.float32(torch.tensor(float(amax) / 2).to(torch.bfloat16).item())
    v = np.concatenate([v, [half, -half, 2 * half]]).astype(np.float32)
    v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()  # the kernel reads bf16
    for bound in (amax, np.float32(2 * half)):
        s_b = np.float32(bound) / np.float32(127)
        np.testing.assert_array_equal(_kernel_quantize(v, s_b),
                                      np.clip(np.rint((v / s_b).astype(np.float32)), -127, 127))
    want = np.clip(np.rint((v / s_x).astype(np.float32)), -127, 127)
    np.testing.assert_array_equal(_kernel_quantize(v, s_x), want)
    q = quant.quantize_activation(torch.from_numpy(v).to(torch.bfloat16)[:, None],
                                  torch.tensor(s_x))
    np.testing.assert_array_equal(q[:, 0].numpy(), want)


def emulate_kernel(x, w_q, s_w, b, k, x_amax, relu, bm, bn):
    """The CUDA kernel's index arithmetic in NumPy, step for step: per
    BM-row tile the 8-aligned halo of input cells quantized once per
    channel slice, the K tiles of 128 bytes (whole taps, or one 128-channel
    slice of a tap), each A row gathered from the halo 16 bytes at a time
    through the tap table, B as the TMA box of w_q (zero past K), then the
    float32 epilogue, ReLU and max|out|."""
    B, C, D, H, W = x.shape
    S, HW = D * H * W, H * W
    M = B * S
    cout, taps, cin_p = w_q.shape
    pad = (k - 1) // 2
    cw = min(cin_p, 128)
    g, n_chunks = 128 // cw, cin_p // cw
    n_tg = -(-taps // g)
    step = HW + W + 1
    reach_lo, reach_hi = pad * step, (k - 1 - pad) * step
    s_x = np.float32(max(np.float32(x_amax), np.float32(1e-12))) / np.float32(127)
    xf = x.float().numpy().reshape(B, C, S)
    wk = w_q.numpy().reshape(cout, taps * cin_p).astype(np.int64)
    K = taps * cin_p
    tap_tab = []
    for t in range(taps):
        dz, dy, dx = t // (k * k) - pad, (t // k) % k - pad, t % k - pad
        tap_tab.append((dz * HW + dy * W + dx, dz, dy, dx))
    acc = np.zeros((M, cout), np.int64)
    for m0 in range(0, M, bm):
        lo = max(m0 - reach_lo, 0) & ~7
        hi = (min(m0 + bm + reach_hi, M) + 7) & ~7
        for c in range(n_chunks):
            halo = np.zeros((hi - lo, cw), np.int64)
            for cell in range(lo, min(hi, M)):
                bb, p = divmod(cell, S)
                chans = np.arange(c * cw, min(c * cw + cw, C))
                halo[cell - lo, :len(chans)] = _kernel_quantize(xf[bb, chans, p], s_x)
            for tg in range(n_tg):
                k0 = tg * g * cin_p + c * cw
                bt = np.zeros((cout, 128), np.int64)
                hi_k = min(k0 + 128, K)
                bt[:, :hi_k - k0] = wk[:, k0:hi_k]
                at = np.zeros((bm, 128), np.int64)
                for r in range(bm):
                    m = m0 + r
                    if m >= M:
                        continue
                    p = m % S
                    z, y, xx = p // HW, (p // W) % H, p % W
                    for j in range(8):
                        o = 16 * j
                        tap, ci = tg * g + o // cw, o % cw
                        if tap >= taps:
                            continue
                        off, dz, dy, dx = tap_tab[tap]
                        if 0 <= z + dz < D and 0 <= y + dy < H and 0 <= xx + dx < W:
                            at[r, o:o + 16] = halo[m - lo + off, ci:ci + 16]
                rows = min(bm, M - m0)
                acc[m0:m0 + rows] += at[:rows] @ bt.T
    scale = (s_w.numpy() * s_x).astype(np.float32)
    y = (acc.astype(np.float32) * scale).astype(np.float32) + b.numpy()
    y = torch.from_numpy(y.astype(np.float32)).to(torch.bfloat16)
    if relu:
        y = torch.nn.functional.relu(y)
    y = y.reshape(B, S, cout).permute(0, 2, 1).reshape(B, cout, D, H, W)
    return y, y.abs().amax().float()


@pytest.mark.parametrize("B,cin,cout,k,r", [
    (2, 20, 12, 3, 4), (2, 42, 21, 5, 4), (3, 60, 40, 1, 4), (2, 126, 16, 2, 4),
    (1, 256, 8, 4, 4), (5, 8, 6, 3, 2), (37, 200, 24, 1, 1), (4, 1536, 7, 1, 1),
    (1, 128, 16, 5, 8),
])
def test_the_kernels_index_arithmetic_computes_the_conv(rng, B, cin, cout, k, r):
    """The kernel's tiling, halo and tap gather, emulated in NumPy, equal the
    plain version bit for bit: halos across batch boundaries, even kernels,
    cin_p 16 to 1536, partial tiles, linears (r = 1) and the channel tail."""
    x = _bf16_case(rng, B, cin, r)
    w_q, s_w, b = _packed_weights(rng, cin, cout, k)
    x_amax = x.abs().amax().float() * 1.1
    want, want_amax = quant.int8_conv3d_fused_reference(x, w_q, s_w, b, k, x_amax, relu=True,
                                                        want_amax=True)
    bm, bn = int8_cuda.tile_shape(B * r ** 3, cout, 132)  # an H100 SXM's SMs
    got, got_amax = emulate_kernel(x, w_q, s_w, b, k, x_amax.item(), True, bm, bn)
    assert torch.equal(got, want) and got_amax.item() == want_amax.item()
    if bm == 128:  # the small-shape tile gives the same outputs
        got64, _ = emulate_kernel(x, w_q, s_w, b, k, x_amax.item(), True, 64, bn)
        assert torch.equal(got64, want)


def direct_geometry(bm, cin_p, k, D, H, W):
    """The direct kernel's geometry (`csrc/int8_conv.cu::direct_geometry`),
    or None where the gather kernel runs (the shared-memory check aside)."""
    w8 = k > 1 and H == 8 and W == 8 and D % (bm // 64) == 0
    if cin_p % 32 or not (k == 1 or w8):
        return None
    P, Hp = bm // 64 + k - 1, 8 + k - 1
    n_cells = P * Hp * Hp if w8 else bm
    lbo = ((n_cells + 6) // 8 * 8 + 1) * 16
    cw = min(cin_p, 64)
    return dict(w8=w8, P=P, Hp=Hp, Wp=Hp, lbo=lbo, cw=cw, n_chunks=cin_p // cw,
                halo_bytes=cw // 16 * lbo)


def emulate_direct(x, w_q, s_w, b, k, x_amax, relu, bm, bn):
    """The direct kernel in NumPy: the halo bytes as the fillers write them
    (16-channel groups `lbo` apart, 16 bytes per cell, the 8 x 8 grids
    zero-padded), and A read through the no-swizzle descriptor: row r, K
    byte j of a k32 step at start + (r // 8) sbo + (r % 8) 16 + (j // 16)
    lbo + j % 16, the start at the tap's cell and the step's group."""
    B, C, D, H, W = x.shape
    S = D * H * W
    M = B * S
    cout, taps, cin_p = w_q.shape
    pad = (k - 1) // 2
    g = direct_geometry(bm, cin_p, k, D, H, W)
    assert g is not None
    s_x = np.float32(max(np.float32(x_amax), np.float32(1e-12))) / np.float32(127)
    xf = x.float().numpy().reshape(B, C, S)
    wk = w_q.numpy().reshape(cout, taps * cin_p).astype(np.int64)
    cw, lbo = g["cw"], g["lbo"]
    sbo = g["Wp"] * 16 if g["w8"] else 128
    acc = np.zeros((M, cout), np.int64)
    rows = np.arange(bm)
    for m0 in range(0, M, bm):
        bb, z0 = m0 // S, (m0 % S) // 64
        for c in range(g["n_chunks"]):
            halo = np.zeros(g["halo_bytes"], np.int64)
            n_runs = g["P"] * 8 if g["w8"] else bm // 8
            for xr in range(n_runs):
                if g["w8"]:
                    zp, y = divmod(xr, 8)
                    z = z0 - pad + zp
                    src = bb * S + (z * 8 + y) * 8 if 0 <= z < D else M
                    cell = (zp * g["Hp"] + y + pad) * g["Wp"] + pad
                else:
                    src, cell = m0 + xr * 8, xr * 8
                for e in range(8):
                    if src + e >= M:
                        continue
                    bi, p = divmod(src + e, S)
                    for ch in range(c * cw, min(c * cw + cw, C)):
                        q = _kernel_quantize(xf[bi, ch:ch + 1, p], s_x)[0]
                        lc = ch - c * cw
                        halo[(lc // 16) * lbo + (cell + e) * 16 + lc % 16] = q
            for t in range(taps):
                if g["w8"]:
                    kd, kh, kw = t // (k * k), (t // k) % k, t % k
                for kk in range(cw // 32):
                    k0 = t * cin_p + c * cw + 32 * kk
                    bt = np.zeros((cout, 32), np.int64)
                    bt[:, :max(0, min(32, taps * cin_p - k0))] = wk[:, k0:k0 + 32]
                    at = np.zeros((bm, 32), np.int64)
                    for wg in range(bm // 64):
                        cell = (((wg + kd) * g["Hp"] + kh) * g["Wp"] + kw) if g["w8"] else wg * 64
                        start = cell * 16 + 2 * kk * lbo
                        r = rows[:64]
                        for j in range(32):
                            addr = start + (r // 8) * sbo + (r % 8) * 16 + (j // 16) * lbo + j % 16
                            at[wg * 64 + r, j] = halo[addr]
                    n = min(bm, M - m0)
                    acc[m0:m0 + n] += at[:n] @ bt.T
    scale = (s_w.numpy() * s_x).astype(np.float32)
    y = (acc.astype(np.float32) * scale).astype(np.float32) + b.numpy()
    y = torch.from_numpy(y.astype(np.float32)).to(torch.bfloat16)
    if relu:
        y = torch.nn.functional.relu(y)
    return y.reshape(B, S, cout).permute(0, 2, 1).reshape(B, cout, D, H, W)


@pytest.mark.parametrize("B,cin,cout,k,r,bm", [
    (1, 42, 21, 3, 8, 128), (1, 60, 24, 5, 8, 64), (2, 20, 16, 1, 4, 64), (37, 130, 8, 1, 1, 64),
    (1, 20, 8, 2, 8, 128),
])
def test_the_direct_kernels_halo_and_descriptors_compute_the_conv(rng, B, cin, cout, k, r, bm):
    """The direct kernel's halo layout and A descriptors (no swizzle: core
    matrices of 8 cells x 16 bytes, `sbo` between rows of cells, `lbo`
    between 16-channel groups), emulated in NumPy, equal the plain version
    bit for bit: the padded 8 x 8 grids (odd and even kernels, BM 64 and
    128) and the 1x1x1 convs and linears."""
    x = _bf16_case(rng, B, cin, r)
    w_q, s_w, b = _packed_weights(rng, cin, cout, k)
    x_amax = x.abs().amax().float() * 1.1
    want, _ = quant.int8_conv3d_fused_reference(x, w_q, s_w, b, k, x_amax, relu=True)
    got = emulate_direct(x, w_q, s_w, b, k, x_amax.item(), True, bm, 32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("switch", ["PART_NO_FILL", "PART_NO_MMA", "PART_NO_B",
                                    "PART_IN_FLIGHT", "PART_TAPS_PER_STAGE"])
def test_kernel_parts_script_switches_the_current_source(switch):
    """`scripts/int8_kernel_parts.py` passes each of its switches to nvcc as
    a macro, and the kernel source tests every one of them."""
    from nestinet_tpu_torch.scripts import int8_kernel_parts

    flags = {f.split("=")[0] for v in int8_kernel_parts.VARIANTS.values() for f in v}
    assert f"-D{switch}" in flags
    with open(int8_cuda.KERNEL.source) as f:
        src = f.read()
    assert f"#ifdef {switch}" in src or f"#ifndef {switch}" in src
