"""The average pool kernel of the port (`csrc/avg_pool.cu`, `ops/kernels/pool_cuda.py`)
and its dispatch in `ops/nn.py::avg_pool3d`.

The kernel runs only on the card, where `chip_smoke.py` phase 5c holds it to
`avg_pool3d_reference` bit for bit.  Here:
  * a NumPy model of its arithmetic and its mapping of threads to volumes
    (the fixed kernel: a block stages a run of whole volumes from a 16-byte
    aligned start, a thread computes output rows (n, d, h), reads the k x k
    input rows of its window as the vectors the kernel loads, sums them over
    D, then H, then W from each window's cell 0 with the SAME pad as +0,
    every add rounded to x.dtype, and divides by the row's counts, on
    bfloat16 pairs as x times the correctly rounded 1 / count; the
    cell-by-cell kernel: one thread an output cell, the same sums, the
    divisor's products rounded to x.dtype and an IEEE divide) equals the
    plain version bit for bit at every average pool of the served backbones,
    of CONV_NET_3G and of TINY, and at shapes only the cell-by-cell kernel
    takes, with NaN, +-inf, +0 and -0 planted, with and without the ReLU,
    but for two things of aten on the CPU: its NaN payloads, and the -0 that
    its ReLU keeps where the card's (fmaxf, and the kernel's) gives +0;
  * in float32 the model equals JAX's separable pool to the tolerance of the
    port's JAX pool tests (`tests/test_torch_nn.py`);
  * x times the correctly rounded 1 / c, rounded to bfloat16, is the IEEE
    x / c rounded to bfloat16 for every bfloat16 x and every c up to 256;
  * a CPU tensor, a tensor whose gradient is recorded, and training's
    non-separable pool take the plain version; a card tensor outside
    autograd takes the kernel, in NCDHW order, and the Inception block
    hands it the pool branch's ReLU;
  * the wrapper refuses a CPU tensor, another dtype, another rank and a
    non-contiguous tensor, and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nestinet_tpu.ops import nn as jnn
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.kernels import pool_cuda

from .test_torch_max_pool import _OnCard, value, vector_bytes
from .test_torch_nn import TOL
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

BITS = {torch.bfloat16: (np.uint16, torch.int16), torch.float32: (np.uint32, torch.int32)}
TILE_BYTES = 16384  # csrc/avg_pool.cu::kTileBytes


def served_avg_pools() -> list:
    """(C, R, k) of every average pool that `chip_smoke.py` phase 5c holds on
    the card (`chip_smoke.py::served_avg_pools`)."""
    import chip_smoke

    return chip_smoke.served_avg_pools()


def test_served_pools_are_the_fixed_volumes():
    """Every served average pool takes the kernel instantiated for whole
    volumes: the manager's 60 / 256 channels at 8^3 (k 3), 512 at 4^3 (k 2)
    and 2^3 (k 1); the experts' 20 / 42 / 60 / 126 / 256 at 8^3, 256 at 4^3
    (k 2), 512 at 2^3 (k 2); SS, MS and SW's 512 at 4^3 (k 3);
    CONV_NET_3G's and TINY's."""
    pools = served_avg_pools()
    assert pools == [(8, 3, 1), (8, 8, 1), (20, 3, 2), (20, 8, 3), (42, 8, 3), (60, 3, 2),
                     (60, 8, 3), (126, 8, 3), (256, 3, 1), (256, 3, 2), (256, 4, 2), (256, 8, 3),
                     (512, 2, 1), (512, 2, 2), (512, 3, 1), (512, 4, 2), (512, 4, 3)]
    assert all(pool_cuda.fixed_volume((r,) * 3, k, 1) for _, r, k in pools)


def planted(rng, shape, dtype) -> torch.Tensor:
    """Normal values in `dtype`, about 0.5% each NaN, +inf and -inf, 4%
    each +0 and -0; whole (sample, channel) volumes of -0, of zeros of both
    signs, of values near the largest finite float32 (their sums overflow)
    and of subnormals."""
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    pick = rng.random(size=shape)
    x[pick < 0.005] = np.nan
    x[(pick >= 0.005) & (pick < 0.01)] = np.inf
    x[(pick >= 0.01) & (pick < 0.015)] = -np.inf
    x[(pick >= 0.015) & (pick < 0.055)] = 0.0
    x[(pick >= 0.055) & (pick < 0.095)] = -0.0
    vols, which = x.reshape(-1, int(np.prod(shape[2:]))), rng.random(size=shape[0] * shape[1])
    vols[which < 0.04] = -0.0
    signs = rng.random(size=(int(((which >= 0.04) & (which < 0.07)).sum()), vols.shape[1]))
    vols[(which >= 0.04) & (which < 0.07)] = np.where(signs < 0.5, np.float32(0.0),
                                                      np.float32(-0.0))
    with np.errstate(over="ignore"):
        vols[(which >= 0.07) & (which < 0.09)] *= np.float32(1e38)
    vols[(which >= 0.09) & (which < 0.11)] *= np.float32(1e-39)
    return torch.from_numpy(x).to(dtype)


def to_bf16(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float32; a NaN stays a NaN."""
    b = v.view(np.uint32).astype(np.uint64)
    r = ((((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16) & 0xFFFFFFFF).astype(np.uint32)
    return np.where(np.isnan(v), v, r.view(np.float32))


def rounded(v: np.ndarray, dtype) -> np.ndarray:
    return to_bf16(v) if dtype == torch.bfloat16 else v


def add(a, b, dtype) -> np.ndarray:
    """The kernel's add: the float32 sum rounded to x.dtype (for bfloat16 the
    native add rounds the exact sum once, which is the same)."""
    with np.errstate(over="ignore", invalid="ignore"):  # inf + -inf, overflowing sums
        return rounded(np.float32(a) + np.float32(b), dtype)


def relu(v: np.ndarray) -> np.ndarray:
    """The card's ReLU: NaN kept, else fmaxf(v, +0), which is +0 at -0."""
    return np.where(np.isnan(v), v, np.where(v > 0, v, np.float32(0.0)))


def pad_lo(size: int, k: int, s: int) -> int:
    return tnn._same_pads(size, k, s)[0]


def valid_cells(o, size: int, k: int, s: int, pad: int):
    """csrc/avg_pool.cu::valid_cells: the window's cells inside the axis."""
    return np.minimum(o * s - pad + k, size) - np.maximum(o * s - pad, 0)


def vols_per_block(R: int, esize: int) -> int:
    """csrc/avg_pool.cu::vols_per_block."""
    vol = R ** 3 * esize
    align = 16 // vector_bytes(vol)
    return max(TILE_BYTES // vol // align * align, align)


def emulate_fixed(cells: np.ndarray, N: int, R: int, k: int, dtype, relu_: bool) -> np.ndarray:
    """`avg_pool3d_kernel<U, R, k>` over every output row at once; returns the
    output values in row order, as float32."""
    esize = 2 if dtype == torch.bfloat16 else 4
    P, V, rows = pad_lo(R, k, 1), vols_per_block(R, esize), R * R
    g = np.arange(N * rows)  # block g // (V rows) computes its rows r in turns of kThreads
    block, r = g // (V * rows), g % (V * rows)
    v0 = block * V
    assert not (v0 * R ** 3 * esize % 16).any()  # every block's run starts aligned
    vol, d, h = r // rows, r % rows // R, r % R
    vec = vector_bytes(R * esize)
    s2 = None
    for i in range(k):
        hh = h - P + i
        s1 = None
        for l in range(k):
            dd = d - P + l
            ok = (hh >= 0) & (hh < R) & (dd >= 0) & (dd < R)
            local = vol * R ** 3 + np.where(ok, dd, 0) * rows + np.where(ok, hh, 0) * R
            assert not (local * esize % vec).any()  # the row's vector loads are aligned
            row = np.where(ok[:, None], cells[(v0 * R ** 3 + local)[:, None] + np.arange(R)],
                           np.float32(0.0))
            s1 = row if l == 0 else add(s1, row, dtype)
        s2 = s1 if i == 0 else add(s2, s1, dtype)
    cdh = valid_cells(d, R, k, 1, P) * valid_cells(h, R, k, 1, P)
    pairs = dtype == torch.bfloat16 and R % 2 == 0
    out = np.empty((N * rows, R), np.float32)
    for w in range(R):
        total = None
        for j in range(k):
            ww = w - P + j
            cell = s2[:, ww] if 0 <= ww < R else np.zeros(N * rows, np.float32)
            total = cell if j == 0 else add(total, cell, dtype)
        count = (cdh * valid_cells(w, R, k, 1, P)).astype(np.float32)
        with np.errstate(all="ignore"):
            if pairs:  # x times the correctly rounded 1 / count, rounded, then the ReLU
                q = to_bf16(total * (np.float32(1.0) / count))
                out[:, w] = relu(q) if relu_ else q
            else:  # the IEEE quotient, the ReLU, then the rounding
                q = total / count
                out[:, w] = rounded(relu(q) if relu_ else q, dtype)
    return out.reshape(-1)


def emulate_any(cells: np.ndarray, shape, k: int, s: int, dtype, relu_: bool) -> np.ndarray:
    """`avg_pool3d_any_kernel<U>`: thread c is output cell (n, od, oh, ow) by
    the divmod chain of c by OW, OH, OD; returns the outputs in that order."""
    N, D, H, W = shape
    OD, OH, OW = (pool_cuda.pooled_size(v, s) for v in (D, H, W))
    pd, ph, pw = (pad_lo(v, k, s) for v in (D, H, W))
    c = np.arange(N * OD * OH * OW)
    ow, oh, od, n = c % OW, c // OW % OH, c // OW // OH % OD, c // OW // OH // OD
    zero = np.zeros(c.size, np.float32)
    total = None
    for j in range(k):
        w = ow * s - pw + j
        s2 = None
        for i in range(k):
            h = oh * s - ph + i
            s1 = None
            for l in range(k):
                d = od * s - pd + l
                ok = (w >= 0) & (w < W) & (h >= 0) & (h < H) & (d >= 0) & (d < D)
                at = ((n * D + np.where(ok, d, 0)) * H + np.where(ok, h, 0)) * W + np.where(ok, w, 0)
                cell = np.where(ok, cells[at], zero)
                s1 = cell if l == 0 else add(s1, cell, dtype)
            s2 = s1 if i == 0 else add(s2, s1, dtype)
        total = s2 if j == 0 else add(total, s2, dtype)
    cdh = rounded((valid_cells(od, D, k, s, pd) * valid_cells(oh, H, k, s, ph)).astype(np.float32),
                  dtype)
    count = rounded(cdh * valid_cells(ow, W, k, s, pw).astype(np.float32), dtype)
    with np.errstate(all="ignore"):
        q = total / count
    return rounded(relu(q) if relu_ else q, dtype)


def emulate(x: torch.Tensor, k: int, s: int, relu_: bool) -> torch.Tensor:
    """`csrc/avg_pool.cu` in NumPy: the kernel `pool_cuda.fixed_volume`
    picks, on the input's bits; NaN comes out as the card's canonical NaN."""
    np_bits, t_bits = BITS[x.dtype]
    B, C, D, H, W = x.shape
    cells = value(x.contiguous().view(t_bits).numpy().view(np_bits).reshape(-1))
    if pool_cuda.fixed_volume((D, H, W), k, s):
        out = emulate_fixed(cells, B * C, W, k, x.dtype, relu_)
    else:
        out = emulate_any(cells, (B * C, D, H, W), k, s, x.dtype, relu_)
    bits = out.view(np.uint32)
    if x.dtype == torch.bfloat16:
        bits = np.where(np.isnan(out), 0x7FFF, bits >> 16).astype(np.uint16)
    shape = (B, C) + tuple(pool_cuda.pooled_size(v, s) for v in (D, H, W))
    return torch.from_numpy(bits.view(t_bits_np(x.dtype))).view(x.dtype).reshape(shape)


def t_bits_np(dtype):
    """The signed NumPy integer of a dtype's bits, which torch takes."""
    return np.int16 if dtype == torch.bfloat16 else np.int32


def check_against_reference(got: torch.Tensor, want: torch.Tensor, relu_: bool) -> None:
    """NaN where the plain version has NaN (aten's CPU keeps NaN payloads that
    the card makes canonical), every other bit equal, but -0 where aten's CPU
    ReLU keeps it and the card's gives +0."""
    _, t_bits = BITS[want.dtype]
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    g, w = got.view(t_bits)[~nan], want.view(t_bits)[~nan]
    differ = g != w
    if relu_:
        neg_zero = torch.tensor(-0.0, dtype=want.dtype).view(t_bits)
        assert (w[differ] == neg_zero).all() and (g[differ] == 0).all()
    else:
        assert not differ.any()


@pytest.mark.parametrize("relu_", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,R,k", served_avg_pools())
def test_the_kernels_arithmetic_computes_the_pool(rng, C, R, k, dtype, relu_):
    """At every served average pool, B = 2: the emulated kernel equals the
    plain version bit for bit, NaN, +-inf, signed zeros, overflowing and
    subnormal volumes included."""
    x = planted(rng, (2, C, R, R, R), dtype)
    got = emulate(x, k, 1, relu_)
    want = tnn.avg_pool3d_reference(x, k, 1, relu_)
    assert got.shape == want.shape == x.shape
    check_against_reference(got, want, relu_)


ANY_SHAPES = [((5, 5, 5), 3, 1), ((4, 5, 7), 3, 1), ((8, 8, 8), 5, 1), ((3, 3, 3), 4, 1),
              ((6, 6, 6), 3, 2), ((2, 7, 9), 4, 3)]


@pytest.mark.parametrize("relu_", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size,k,s", ANY_SHAPES)
def test_the_cell_by_cell_kernel_computes_the_pool(rng, size, k, s, dtype, relu_):
    """Grids no fixed instance takes (strides 2 and 3, windows wider than the
    grid, grids not cubic; `chip_smoke.py::AVG_POOL_ELEMENT_WISE`): the
    cell-by-cell kernel's model equals the plain version bit for bit."""
    import chip_smoke

    assert list(chip_smoke.AVG_POOL_ELEMENT_WISE) == ANY_SHAPES
    assert not pool_cuda.fixed_volume(size, k, s)
    x = planted(rng, (3, 5) + size, dtype)
    check_against_reference(emulate(x, k, s, relu_), tnn.avg_pool3d_reference(x, k, s, relu_),
                            relu_)


def test_the_reciprocal_quotient_is_the_divide():
    """Every bfloat16 x and every count c up to 256 (the fixed kernel's
    divisors are at most k^3 = 27): x times the correctly rounded 1 / c,
    rounded to bfloat16, has the bits of the IEEE x / c rounded to bfloat16."""
    x = (np.arange(2 ** 16, dtype=np.uint32) << 16).view(np.float32)
    with np.errstate(all="ignore"):
        for c in np.arange(1, 257, dtype=np.float32):
            got, want = to_bf16(x * (np.float32(1.0) / c)), to_bf16(x / c)
            same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got)
                                                                    & np.isnan(want))
            assert same.all(), c


JAX_SHAPES = [(C, (R,) * 3, k, 1) for C, R, k in served_avg_pools() if C <= 60] + [
    (6, (4, 5, 7), 3, 1), (6, (6, 6, 6), 3, 2)]


@pytest.mark.parametrize("relu_", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("C,size,k,s", JAX_SHAPES)
def test_the_model_equals_jax_in_float32(rng, C, size, k, s, relu_):
    """JAX's separable pool (`nestinet_tpu/ops/nn.py:394-414`) on the same
    float32 values, with jax.nn.relu where the branch has it: equal to the
    model at the tolerance of the port's JAX pool tests, NaN and inf where
    JAX has them."""
    import jax

    x = planted(rng, (2, C) + size, torch.float32)
    got = emulate(x, k, s, relu_).numpy()
    want = jnn.avg_pool3d(jnp.asarray(x.permute(0, 2, 3, 4, 1).numpy()), k, s)
    if relu_:
        want = jax.nn.relu(want)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 4, 1, 2, 3), **TOL)


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kernel's wrapper replaced by a recorder that returns the plain
    pool: the arguments of each call the dispatch makes."""
    calls = []

    def recorder(x, kernel, stride, relu=False):
        assert x.is_contiguous()
        calls.append((tuple(x.shape), kernel, stride, relu))
        return tnn.avg_pool3d_reference(x.as_subclass(torch.Tensor), kernel, stride, relu)

    monkeypatch.setattr(pool_cuda, "avg_pool3d_cuda", recorder)
    return calls


def test_dispatch_cpu_tensors_take_the_plain_version(rng, kernel_calls):
    x = planted(rng, (2, 4, 8, 8, 8), torch.float32)
    with torch.inference_mode():
        out = tnn.avg_pool3d(x, 3, 1, relu=True)
    assert kernel_calls == []
    want = tnn.avg_pool3d_reference(x, 3, 1, relu=True)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    out = tnn.avg_pool3d(tnn.ActQ(x, torch.tensor(3.0)), 2, 1)
    assert kernel_calls == [] and isinstance(out, tnn.ActQ) and out.amax.item() == 3.0


def test_dispatch_card_tensors_take_the_kernel_outside_autograd(rng, kernel_calls):
    """Serving (inference mode), the eval step (no_grad) and a tensor that
    needs no gradient take the kernel; a tensor whose gradient is recorded
    and training's non-separable pool take the plain version."""
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32)).as_subclass(_OnCard)
    assert x.is_cuda
    with torch.inference_mode():
        tnn.avg_pool3d(x, 3, 1)
    with torch.no_grad():
        tnn.avg_pool3d(x.requires_grad_(True), 3, 1, relu=True)
    x.requires_grad_(False)
    out = tnn.avg_pool3d(tnn.ActQ(x, torch.tensor(2.0)), 2, 1)
    assert isinstance(out, tnn.ActQ) and out.amax.item() == 2.0
    assert kernel_calls == [((2, 3, 4, 4, 4), 3, 1, False), ((2, 3, 4, 4, 4), 3, 1, True),
                            ((2, 3, 4, 4, 4), 2, 1, False)]
    x.requires_grad_(True)
    out = tnn.avg_pool3d(x, 3, 1)
    assert len(kernel_calls) == 3 and out.requires_grad
    out.sum().backward()
    assert x.grad is not None
    with torch.no_grad():
        tnn.avg_pool3d(x, 3, 1, separable=False)
    assert len(kernel_calls) == 3


def test_dispatch_hands_the_kernel_ncdhw_order(rng, kernel_calls):
    """A card tensor in channels-last strides reaches the kernel contiguous,
    and the pool is the plain version's."""
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 8, 6)).astype(np.float32))
    x = x.permute(0, 4, 1, 2, 3).as_subclass(_OnCard)
    assert not x.is_contiguous()
    with torch.inference_mode():
        out = tnn.avg_pool3d(x, 3, 1, relu=True)
    assert kernel_calls == [((1, 6, 8, 8, 8), 3, 1, True)]
    want = tnn.avg_pool3d_reference(x.as_subclass(torch.Tensor), 3, 1, relu=True)
    assert torch.equal(out.as_subclass(torch.Tensor), want)


@pytest.mark.parametrize("cin,relu_", [(24, True), (6, False)])
def test_inception_hands_the_pool_its_relu(rng, monkeypatch, cin, relu_):
    """At inference with cin > n the pool branch's ReLU rides the pool
    (`relu=True`), and the block equals the unfused relu(pool(conv4(x)));
    with cin <= n the pool runs on x without it."""
    block = tnn.Inception3D(cin, 8, (3, 5)).eval()
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.2)
    seen, real = [], tnn.avg_pool3d

    def spy(x, kernel, stride, **kw):
        seen.append(kw.get("relu", False))
        return real(x, kernel, stride, **kw)

    x = torch.from_numpy(rng.normal(size=(2, cin, 5, 5, 5)).astype(np.float32))
    with torch.inference_mode():
        monkeypatch.setattr(tnn, "avg_pool3d", spy)
        out = block(x)
        monkeypatch.setattr(tnn, "avg_pool3d", real)
        assert seen == [relu_]
        if relu_:
            pooled = F.relu(tnn.avg_pool3d_reference(block.conv4(x, relu=False), 3, 1))
        else:
            pooled = block.conv4(tnn.avg_pool3d_reference(x, 3, 1))
    assert torch.equal(out[:, -8:], pooled)


def test_cuda_wrapper_refuses_what_it_does_not_take():
    """A CPU tensor, another dtype, another rank and a non-contiguous
    tensor raise, and no launch is counted."""
    before = dict(pool_cuda.AVG_POOL.launches)
    x = torch.zeros((1, 4, 8, 8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pool_cuda.avg_pool3d_cuda(x, 3, 1)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pool_cuda.avg_pool3d_cuda(x.half(), 3, 1)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pool_cuda.avg_pool3d_cuda(x.double(), 3, 1, relu=True)
    with pytest.raises(ValueError, match="B, C, D, H, W"):
        pool_cuda.avg_pool3d_cuda(x[0], 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        pool_cuda.avg_pool3d_cuda(x.transpose(2, 4), 3, 1)
    assert pool_cuda.AVG_POOL.launches == before == {"avg_pool3d": 0}
