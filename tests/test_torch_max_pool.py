"""The max pool kernel of the port (`csrc/max_pool.cu`, `ops/kernels/pool_cuda.py`)
and its dispatch in `ops/nn.py::max_pool3d`.

The kernel runs only on the card, where `chip_smoke.py` holds it to
`F.max_pool3d` bit for bit.  Here:
  * a NumPy model of its index arithmetic (one thread an output row (n, od,
    oh), its k x k input rows read as the vectors the kernel loads, the
    window's cells taken in kd, kh, kw order with aten's "strictly greater
    or NaN" step, the outputs stored as the kernel stores them) equals the
    plain version bit for bit at every pool of the served backbones, of
    CONV_NET_3G and of TINY, and at shapes only the element-wise kernel
    takes, with NaN, -inf, +0 and -0 planted; and JAX's `max_pool3d` but
    for the sign of a zero, which JAX's max takes as +0 where aten keeps the
    first zero of the window;
  * a CPU tensor, and a tensor whose gradient is recorded, take the plain
    version; a card tensor outside autograd takes the kernel, in NCDHW
    order whatever its strides;
  * the wrapper refuses a CPU tensor, another dtype, another rank and a
    non-contiguous tensor, and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.ops import nn as jnn
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.kernels import pool_cuda

from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

BITS = {torch.bfloat16: (np.uint16, torch.int16), torch.float32: (np.uint32, torch.int32)}


def served_pools() -> list:
    """(C, R, k, s) of every pool that `chip_smoke.py` phase 5b holds on the
    card (`chip_smoke.py::served_pools`)."""
    import chip_smoke

    return chip_smoke.served_pools()


def test_served_pools_are_the_fixed_rows():
    """Every served pool takes the kernel instantiated for whole rows."""
    pools = served_pools()
    assert pools == [(24, 3, 2, 2), (24, 8, 2, 2), (768, 4, 2, 2), (768, 8, 2, 2),
                     (1536, 2, 2, 2), (1536, 3, 3, 2), (1536, 4, 2, 2)]
    assert all(pool_cuda.fixed_row(r, k, s) for _, r, k, s in pools)


def planted(rng, shape, dtype) -> torch.Tensor:
    """Normal values in `dtype`, about 4% each NaN (the canonical quiet NaN,
    as aten's CPU pool writes it), -inf, +0 and -0, and some whole rows of
    zeros of both signs and of -inf."""
    x = rng.normal(size=shape).astype(np.float32)
    pick = rng.random(size=shape)
    x[(pick >= 0.04) & (pick < 0.08)] = -np.inf
    x[(pick >= 0.08) & (pick < 0.12)] = 0.0
    x[(pick >= 0.12) & (pick < 0.16)] = -0.0
    rows, which = x.reshape(-1, shape[-1]), rng.random(size=x.size // shape[-1])
    zeros = rng.random(size=(int((which < 0.05).sum()), shape[-1])) < 0.5
    rows[which < 0.05] = np.where(zeros, np.float32(0.0), np.float32(-0.0))
    rows[(which >= 0.05) & (which < 0.08)] = -np.inf
    out = torch.from_numpy(x).to(dtype)
    _, t_bits = BITS[dtype]
    nan = torch.tensor(float("nan"), dtype=dtype).view(t_bits)
    out.view(t_bits)[torch.from_numpy(pick < 0.04)] = nan
    return out


def value(bits: np.ndarray) -> np.ndarray:
    """float32 values of bfloat16 or float32 bits."""
    if bits.dtype == np.uint16:
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return bits.view(np.float32)


def vector_bytes(nbytes: int) -> int:
    """The widest load or store, up to 16 bytes, that a row of `nbytes`
    bytes splits into (`csrc/max_pool.cu::gcd16`)."""
    return next(v for v in (16, 8, 4, 2, 1) if nbytes % v == 0)


def emulate(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """`csrc/max_pool.cu` in NumPy, every output row at once: thread r is
    row (n, od, oh) = divmod chain of r by OH then OD; the fixed kernel
    reads each in-grid input row (kd, kh) whole as vectors of
    `vector_bytes(W * esize)` from the 16-byte aligned base and feeds cell
    iw to output ow where iw - (ow s - pw) lies in [0, k); the element-wise
    kernel reads cell (kd, kh, kw) by cell; both take aten's step and store
    OW outputs at r OW."""
    np_bits, t_bits = BITS[x.dtype]
    esize = np.dtype(np_bits).itemsize
    B, C, D, H, W = x.shape
    N = B * C
    OD, OH, OW = (pool_cuda.pooled_size(v, s) for v in (D, H, W))
    pd, ph, pw = (tnn._same_pads(v, k, s)[0] for v in (D, H, W))
    x_bytes = x.contiguous().view(t_bits).numpy().view(np_bits).reshape(-1).view(np.uint8)
    rows = N * OD * OH
    r = np.arange(rows)
    oh, t = r % OH, r // OH
    od, n = t % OD, t // OD
    best = np.full((rows, OW), -np.inf, np.float32)
    best_bits = np.full((rows, OW), np.float32(-np.inf).view(np.uint32) >> (32 - 8 * esize),
                        np_bits)

    def take(cell_bits, ow, ok):
        v = value(cell_bits)
        step = ok & ((v > best[:, ow]) | np.isnan(v))
        best[step, ow] = v[step]
        best_bits[step, ow] = cell_bits[step]

    fixed = pool_cuda.fixed_row(W, k, s)
    vec = vector_bytes(W * esize)
    for kd in range(k):
        idd = od * s - pd + kd
        for kh in range(k):
            ih = oh * s - ph + kh
            ok = (idd >= 0) & (idd < D) & (ih >= 0) & (ih < H)
            start = ((n * D + np.where(ok, idd, 0)) * H + np.where(ok, ih, 0)) * W * esize
            if fixed:
                assert not (start % vec).any()
                loads = start[:, None] + vec * np.arange(W * esize // vec)
                row_bytes = x_bytes[loads[:, :, None] + np.arange(vec)].reshape(rows, -1)
                cells = row_bytes.copy().view(np_bits)  # [rows, W]
                for iw in range(W):
                    for ow in range(OW):
                        if 0 <= iw - (ow * s - pw) < k:
                            take(cells[:, iw], ow, ok)
            else:
                for ow in range(OW):
                    for kw in range(k):
                        iw = ow * s - pw + kw
                        if 0 <= iw < W:
                            cell = start + iw * esize
                            take(x_bytes[cell[:, None] + np.arange(esize)].copy()
                                 .view(np_bits)[:, 0], ow, ok)
    if fixed:
        out_vec = vector_bytes(OW * esize)
        assert not ((r * OW * esize) % out_vec).any()
    out = torch.from_numpy(best_bits.reshape(-1).view(np.int16 if esize == 2 else np.int32))
    return out.view(x.dtype).reshape(B, C, OD, OH, OW)


def jax_max_pool(x: torch.Tensor, k: int, s: int) -> np.ndarray:
    """JAX's max pool of the same values, NCDHW, as float32."""
    xj = jnp.asarray(x.float().permute(0, 2, 3, 4, 1).numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    out = jnn.max_pool3d(xj, k, s).astype(jnp.float32)
    return np.asarray(out).transpose(0, 4, 1, 2, 3)


def f32_bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.uint32)


def check_against_jax(got: torch.Tensor, want: np.ndarray) -> None:
    """Bits equal but where both are zeros: there JAX's max gives +0 and
    the kernel, as aten, the first zero of the window."""
    g, w = f32_bits(got.float().numpy()), f32_bits(want)
    zeros = (g << 1 == 0) & (w << 1 == 0)
    assert np.array_equal(g[~zeros], w[~zeros])
    assert not ((g != w) & zeros & (w != 0)).any()  # JAX's differing zero is +0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,R,k,s", served_pools())
def test_the_kernels_index_arithmetic_computes_the_pool(rng, dtype, C, R, k, s):
    """At every served pool, B = 2: the emulated kernel equals the plain
    version (aten) bit for bit, NaN, -inf and signed zeros included, and
    JAX's max pool but for the sign of a zero."""
    x = planted(rng, (2, C, R, R, R), dtype)
    got = emulate(x, k, s)
    want = tnn.max_pool3d_reference(x, k, s)
    assert got.shape == want.shape == (2, C) + (pool_cuda.pooled_size(R, s),) * 3
    _, t_bits = BITS[dtype]
    assert torch.equal(got.view(t_bits), want.view(t_bits))
    check_against_jax(got, jax_max_pool(x, k, s))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size,k,s", [((5, 5, 5), 2, 2), ((4, 5, 7), 3, 2), ((6, 6, 6), 3, 1),
                                      ((8, 8, 8), 1, 1), ((3, 3, 3), 5, 2), ((2, 7, 9), 4, 3)])
def test_the_element_wise_kernel_computes_the_pool(rng, dtype, size, k, s):
    """Rows no fixed instance takes (odd widths, strides 1 and 3, windows
    wider than the grid, grids not cubic): the element-wise kernel's model
    equals the plain version bit for bit."""
    assert not pool_cuda.fixed_row(size[-1], k, s)
    x = planted(rng, (3, 5) + size, dtype)
    got = emulate(x, k, s)
    _, t_bits = BITS[dtype]
    assert torch.equal(got.view(t_bits), tnn.max_pool3d_reference(x, k, s).view(t_bits))
    check_against_jax(got, jax_max_pool(x, k, s))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the dispatch reads."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kernel's wrapper replaced by a recorder that returns the plain
    pool: the arguments of each call the dispatch makes."""
    calls = []

    def recorder(x, kernel, stride):
        assert x.is_contiguous()
        calls.append((tuple(x.shape), kernel, stride))
        return tnn.max_pool3d_reference(x.as_subclass(torch.Tensor), kernel, stride)

    monkeypatch.setattr(pool_cuda, "max_pool3d_cuda", recorder)
    return calls


def test_dispatch_cpu_tensors_take_the_plain_version(rng, kernel_calls):
    x = planted(rng, (2, 4, 8, 8, 8), torch.float32)
    with torch.inference_mode():
        out = tnn.max_pool3d(x, 2, 2)
    assert kernel_calls == []
    assert torch.equal(out.view(torch.int32), tnn.max_pool3d_reference(x, 2, 2).view(torch.int32))
    out = tnn.max_pool3d(tnn.ActQ(x, torch.tensor(3.0)), 3, 2)
    assert kernel_calls == [] and isinstance(out, tnn.ActQ) and out.amax.item() == 3.0


def test_dispatch_card_tensors_take_the_kernel_outside_autograd(rng, kernel_calls):
    """Serving (inference mode), the eval step (no_grad) and a tensor that
    needs no gradient take the kernel; a tensor whose gradient is recorded
    (training's forward) takes the plain version, and its gradient flows."""
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32)).as_subclass(_OnCard)
    assert x.is_cuda
    with torch.inference_mode():
        tnn.max_pool3d(x, 2, 2)
    with torch.no_grad():
        tnn.max_pool3d(x.requires_grad_(True), 2, 2)
    x.requires_grad_(False)
    tnn.max_pool3d(x, 2, 2)
    assert kernel_calls == [((2, 3, 4, 4, 4), 2, 2)] * 3
    x.requires_grad_(True)
    out = tnn.max_pool3d(x, 2, 2)
    assert len(kernel_calls) == 3 and out.requires_grad
    out.sum().backward()
    assert x.grad is not None and x.grad.sum().item() == 2 * 3 * 8


def test_dispatch_hands_the_kernel_ncdhw_order(rng, kernel_calls):
    """A card tensor in channels-last strides (a permuted NDHWC grid through
    cuDNN, as a single sample can come) reaches the kernel contiguous, and
    the pool is the plain version's."""
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 8, 6)).astype(np.float32))
    x = x.permute(0, 4, 1, 2, 3).as_subclass(_OnCard)
    assert not x.is_contiguous()
    with torch.inference_mode():
        out = tnn.max_pool3d(x, 2, 2)
    assert kernel_calls == [((1, 6, 8, 8, 8), 2, 2)]
    want = tnn.max_pool3d_reference(x.as_subclass(torch.Tensor), 2, 2)
    assert torch.equal(out.as_subclass(torch.Tensor), want)


def test_cuda_wrapper_refuses_what_it_does_not_take():
    """A CPU tensor, another dtype, another rank and a non-contiguous
    tensor raise, and no launch is counted."""
    before = dict(pool_cuda.POOL.launches)
    x = torch.zeros((1, 4, 8, 8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pool_cuda.max_pool3d_cuda(x, 2, 2)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pool_cuda.max_pool3d_cuda(x.half(), 2, 2)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pool_cuda.max_pool3d_cuda(x.double(), 2, 2)
    with pytest.raises(ValueError, match="B, C, D, H, W"):
        pool_cuda.max_pool3d_cuda(x[0], 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pool_cuda.max_pool3d_cuda(x.transpose(2, 4), 2, 2)
    assert pool_cuda.POOL.launches == before == {"max_pool3d": 0}
