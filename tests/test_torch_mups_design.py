"""The MuPS CUDA kernels' arithmetic and tiling, emulated exactly on the CPU.

`csrc/mups_kernel.cu` runs only on the card.  What can be checked here is
its arithmetic, in NumPy:

* the shared-divisor division (`div_by`: q0 = a r, e = fma(-q0, b, a),
  q = fma(e, r, q0) with r = RN(1 / b)), emulated with exact float32
  rounding of the FMA, against IEEE float32 division over every (point,
  Gaussian) pair of seeded flagship rows, the flagship and 3^3 Gaussians'
  sigmas and the rows' denominators (which the kernel carries times 2^64,
  as it does the weighted pdfs);
* the kernel's scheme (`emulate_rows`): the walk over a row's real points
  in tiles, the denominators reduced in the kernel's order (the warps'
  reduce-scatter butterfly, then across warps), the float64 statistics
  sums, masked rows, n_eff = 0 and N - 1, K = 27, 64 and 1000 on warps of
  32 threads, against the port's `tdmfv_n_est_reference` and JAX's
  `tdmfv_n_est` at atol 1e-5 (the bar `tests/test_pallas_mups.py` holds
  the Pallas kernel to).  NumPy's float32 exp and 1/sqrt stand for the
  card's expf and rsqrtf, which may differ from them by an ulp.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu.ops.mups import tdmfv_n_est
from nestinet_tpu_torch.ops import mups as torch_mups

f32, f64 = np.float32, np.float64
WARP = 32
UP = f32(2.0 ** 64)
TWO_PI_POW_1P5 = f32(15.749609945722419)

torch.set_num_threads(1)


# ---- exact float32 rounding of x + y, x * y + z ----------------------------

def rn32_sum(x, y):
    """float32(x + y) rounded once, for float64 arrays x, y that hold exact
    values (float32 numbers or products of two).  TwoSum gives the exact sum
    as s + err; RN32 of it equals RN32(s) unless s is itself a float32
    midpoint, where err breaks the tie."""
    x, y = np.asarray(x, f64), np.asarray(y, f64)
    s = x + y
    bv = s - x
    err = (x - (s - bv)) + (y - bv)
    f = s.astype(f32)
    ff = f.astype(f64)
    toward = np.where(s > ff, f32(np.inf), f32(-np.inf)).astype(f32)
    other = np.nextafter(f, toward).astype(f64)
    midpoint = (ff != s) & (s == (ff + other) / 2)
    tie = np.where(err > 0, np.maximum(ff, other), np.minimum(ff, other))
    return np.where(midpoint & (err != 0), tie, ff).astype(f32)


def fma32(a, b, c):
    """The card's __fmaf_rn: a * b + c rounded once to float32."""
    return rn32_sum(np.asarray(a, f64) * np.asarray(b, f64), c)


def div_by(a, b, r):
    """The kernel's division by a shared divisor b with r = RN(1 / b)."""
    a = np.asarray(a, f32)
    q0 = a * r
    e = fma32(-q0, b, a)
    return fma32(e, r, q0)


def reciprocal(b, lo, hi):
    """The kernel's shared_reciprocal: RN(1 / b), or 0 outside [lo, hi]."""
    m = np.abs(b)
    with np.errstate(divide="ignore", over="ignore"):
        r = f32(1) / b
    return np.where((m >= lo) & (m <= hi), r, f32(0)).astype(f32)


SIGMA_RANGE = (f32(2.0 ** -64), f32(2.0 ** 64))
DEN_RANGE = (f32(1), f32(2.0 ** 104))  # den times 2^64: den in [2^-64, 2^40]


def _to_fraction(x) -> Fraction:
    return Fraction(float(x))


@pytest.mark.parametrize("kind", ["random", "midpoints"])
def test_fma_emulation_rounds_once(kind):
    """fma32 against exact rational arithmetic, on random triples and on
    triples whose exact result sits next to a float32 midpoint."""
    rng = np.random.RandomState(11)
    n = 400
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.randint(-20, 20, n)).astype(f32)
    b = (rng.uniform(1, 2, n) * 2.0 ** rng.randint(-20, 20, n)).astype(f32)
    c = -(a.astype(f64) * b).astype(f32)
    if kind == "midpoints":
        # c = -RN(a b) + half an ulp of it: the exact a b + c lies within
        # an ulp of the product's rounding error of a midpoint
        ulp = np.spacing(np.abs(c)).astype(f64)
        c = (c.astype(f64) + np.sign(c) * ulp / 2).astype(f32)
    got = fma32(a, b, c)
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = _to_fraction(ai) * _to_fraction(bi) + _to_fraction(ci)
        lo = f32(float(exact))  # nearest double, then float32: check against both neighbours
        cands = {lo, np.nextafter(lo, f32(np.inf)), np.nextafter(lo, f32(-np.inf))}
        best = min(cands, key=lambda v: (abs(_to_fraction(v) - exact),
                                         int(np.asarray(v, f32).view(np.int32)) & 1))
        assert gi == best, (ai, bi, ci, gi, best)


# ---- the division against IEEE float32 division -----------------------------

def _gmm(m, variance=None):
    return get_3d_grid_gmm([m, m, m], variance=(1.0 / m) ** 2 if variance is None
                           else variance).astuple()


def _flagship_rows(R, N=512, seed=5):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (R, N, 3)).astype(f32)


def _pdf_terms(pts, w, mu, sigma, scale=f32(1)):
    """wp [R, N, K] in float32 and the rows' denominators [R, N]: the plain
    version's arithmetic, with the pdf coefficient times `scale` (the
    kernel's 2^64)."""
    a = pts[:, :, None, :] - mu[None, None]
    s = a / sigma[None, None]
    d2 = (s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]) + s[..., 2] * s[..., 2]
    s0 = sigma[:, 0]
    coef = (f32(1) / (TWO_PI_POW_1P5 * ((s0 * s0) * s0))) * scale
    with np.errstate(under="ignore"):
        wp = (coef * np.exp(f32(-0.5) * d2)) * w
    den = wp.astype(f64).sum(-1).astype(f32)
    return wp, den


@pytest.mark.parametrize("gaussians", ["flagship", "grid3"])
def test_offsets_divided_as_ieee(gaussians):
    """(p - mu) / sigma for every (point, Gaussian, axis) of two seeded
    flagship rows (512 points): bit for bit IEEE division.  grid3 holds a
    Gaussian at the origin, where p - mu = p."""
    w, mu, sigma = _gmm(8, 0.0156) if gaussians == "flagship" else _gmm(3, 1.0 / 9)
    pts = _flagship_rows(2)
    a = pts[:, :, None, :] - mu[None, None]
    r = reciprocal(sigma, *SIGMA_RANGE)
    assert (r != 0).all()  # every sigma takes the shared reciprocal
    got = div_by(a, sigma[None, None], r[None, None])
    want = a / sigma[None, None]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gaussians", ["flagship", "grid3"])
def test_soft_assignment_divided_as_ieee(gaussians):
    """q = wp / den as the kernel takes it, (wp 2^64) / (den 2^64) with the
    pdf coefficient scaled once, for every pair of two flagship rows: the
    denominators are the plain ones times 2^64 exactly, and q is bit for
    bit IEEE wp / den wherever wp and q are normal floats (a subnormal wp,
    below 2^-126, carries more bits scaled than the plain version keeps)."""
    w, mu, sigma = _gmm(8, 0.0156) if gaussians == "flagship" else _gmm(3, 1.0 / 9)
    pts = _flagship_rows(2)
    wp, den = _pdf_terms(pts, w, mu, sigma)
    wp_s, den_s = _pdf_terms(pts, w, mu, sigma, scale=UP)
    np.testing.assert_array_equal(den_s, den * UP)
    r = reciprocal(den_s, *DEN_RANGE)
    assert (r != 0).all()  # every row denominator takes the shared reciprocal
    got = div_by(wp_s, den_s[..., None], r[..., None])
    want = wp / den[..., None]
    normal = (wp >= f32(2.0 ** -126)) & (want >= f32(2.0 ** -126))
    assert normal.mean() > 0.5
    np.testing.assert_array_equal(got[normal], want[normal])
    assert np.abs(got[~normal].astype(f64) - want[~normal]).max(initial=0) <= 2.0 ** -120


def test_plain_corrected_division_needs_the_scaling():
    """Without the 2^64 scaling the residual of a tiny wp underflows and
    the corrected quotient is off: the reason the kernel scales."""
    rng = np.random.RandomState(3)
    b = (rng.uniform(1, 2, 20000) * 2.0 ** rng.randint(-14, 4, 20000)).astype(f32)
    a = (rng.uniform(1, 2, 20000) * 2.0 ** rng.randint(-126, -100, 20000)).astype(f32)
    r = f32(1) / b
    want = a / b
    normal = want >= f32(2.0 ** -126)
    plain = div_by(a, b, r)
    scaled = div_by(a * UP, b * UP, r / UP)  # both times 2^64, as the kernel
    assert (plain != want)[normal].any()
    np.testing.assert_array_equal(scaled[normal], want[normal])


@pytest.mark.parametrize("decades", [(-100, 0), (-40, 40)])
def test_random_quotients_divided_as_ieee(decades):
    """Random dividends with |a| >= 2^-100 over divisors across the guarded
    range [2^-64, 2^64]: identical to IEEE division wherever the quotient
    is normal."""
    rng = np.random.RandomState(7)
    n = 200000
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.randint(*decades, n)).astype(f32)
    a *= rng.choice([-1, 1], n).astype(f32)
    b = (rng.uniform(1, 2, n) * 2.0 ** rng.randint(-64, 64, n)).astype(f32)
    b[: n // 4] = f32(2) - f32(2.0 ** -23) * rng.randint(1, 64, n // 4).astype(f32)  # 1.11...1
    r = reciprocal(b, *SIGMA_RANGE)
    with np.errstate(under="ignore"):
        want = a / b
        got = div_by(a, b, r)
    normal = np.abs(want) >= f32(2.0 ** -126)
    np.testing.assert_array_equal(got[normal], want[normal])


# ---- the kernel's scheme, emulated ------------------------------------------

def warp_den(wp_tile):
    """The kernel's warp_den over [T, Kp] float32 weighted pdfs: per warp,
    the reduce-scatter butterfly in double; returns [warps, T]."""
    T, Kp = wp_tile.shape
    nw = Kp // WARP
    v = wp_tile.astype(f64).T.reshape(nw, WARP, T).copy()  # [warp, lane, j]
    lane = np.arange(WARP)
    off, half = WARP // 2, T // 2
    while half >= 1:
        upper = (lane & off) != 0
        new = v.copy()
        for i in range(half):
            send = np.where(upper, v[:, :, i], v[:, :, i + half])
            keep = np.where(upper, v[:, :, i + half], v[:, :, i])
            new[:, :, i] = keep + send[:, lane ^ off]
        v = new
        half //= 2
        off //= 2
    x = v[:, :, 0]
    while off > 0:
        x = x + x[:, lane ^ off]
        off //= 2
    return x[:, :: WARP // T]  # point j sits in lane j * (32 / T)


def tile_denominators(part):
    """The kernel's tile_denominators: [warps, T] partial sums -> float32
    [T], in warp 0's order."""
    nw, T = part.shape
    lane = np.arange(WARP)
    j, c = lane % T, lane // T
    den = np.zeros(WARP)
    for L in range(WARP):
        acc = 0.0
        for i in range(c[L], nw, WARP // T):
            acc += part[i, j[L]]
        den[L] = acc
    off = T
    while off < WARP:
        den = den + den[lane ^ off]
        off *= 2
    return den[:T].astype(f32)


def emulate_row(pts, ne, w, mu, sigma, tile):
    """One row of the kernel, [N, 3] float32 points -> [20, K]."""
    N, K = pts.shape[0], mu.shape[0]
    kp = -(-K // WARP) * WARP  # threads of the block: one Gaussian each
    pad = kp - K
    mu_p = np.concatenate([mu, np.zeros((pad, 3), f32)])
    sig_p = np.concatenate([sigma, np.ones((pad, 3), f32)])
    w_p = np.concatenate([w, np.ones(pad, f32)])
    s0 = sig_p[:, 0]
    coef = np.concatenate([(f32(1) / (TWO_PI_POW_1P5 * ((s0 * s0) * s0)))[:K] * UP,
                           np.zeros(pad, f32)])  # times 2^64, as wp and den
    rsig = reciprocal(sig_p, *SIGMA_RANGE)
    assert (rsig != 0).all()
    rsw = (f32(1) / np.sqrt(w_p)).astype(f32)
    n_real = max(min(int(ne), N - 1) + 1, 0)
    n_pad = -(-n_real // tile) * tile
    tiles = np.zeros((n_pad, 3), f32)
    tiles[:n_real] = pts[:n_real]

    pi_max = np.full(kp, -np.inf, f32)
    mx = np.full((3, kp), -np.inf, f32)
    mn = np.full((3, kp), np.inf, f32)
    smx = np.full((3, kp), -np.inf, f32)
    smn = np.full((3, kp), np.inf, f32)
    pi_sum = np.zeros(kp)  # the float64 sums
    mu_sum, sg_sum = np.zeros((3, kp)), np.zeros((3, kp))
    for n0 in range(0, n_real, tile):
        p = tiles[n0:n0 + tile]
        s = div_by(p[:, None, :] - mu_p[None], sig_p[None], rsig[None])  # [T, Kp, 3]
        d2 = (s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]) + s[..., 2] * s[..., 2]
        with np.errstate(under="ignore"):
            wp = (coef * np.exp(f32(-0.5) * d2)) * w_p  # [T, Kp]
        den = tile_denominators(warp_den(wp))
        nt = min(tile, n_real - n0)
        r = reciprocal(den, *DEN_RANGE)
        assert (r[:nt] != 0).all()
        for j in range(nt):
            q = div_by(wp[j], den[j], r[j])
            dpi = (q - w_p) * rsw
            pi_max = np.maximum(pi_max, dpi)
            pi_sum += dpi
            for d in range(3):
                a = q * s[j, :, d]
                b = q * (s[j, :, d] * s[j, :, d] - f32(1))
                mx[d], mn[d] = np.maximum(mx[d], a), np.minimum(mn[d], a)
                smx[d], smn[d] = np.maximum(smx[d], b), np.minimum(smn[d], b)
                mu_sum[d] += a
                sg_sum[d] += b
    if n_real < N:  # masked rows: zeros in every max/min
        pi_max = np.maximum(pi_max, f32(0))
        mx, mn = np.maximum(mx, f32(0)), np.minimum(mn, f32(0))
        smx, smn = np.maximum(smx, f32(0)), np.minimum(smn, f32(0))
    rs2w = (f32(1) / np.sqrt(f32(2) * w_p)).astype(f32)
    mu_tot, sg_tot = mu_sum.astype(f32), sg_sum.astype(f32)
    v = np.stack([pi_max, pi_sum.astype(f32), *(mx * rsw), *(mn * rsw), *(mu_tot * rsw),
                  *(smx * rs2w), *(smn * rs2w), *(sg_tot * rs2w)])[:, :K]
    v = v / f32(max(int(ne), 1))
    v = np.sign(v) * np.sqrt(np.abs(v))
    sq = (v * v).astype(f64).sum(1).astype(f32)
    return v * (f32(1) / np.sqrt(np.maximum(sq, f32(1e-12))))[:, None]


def emulate_rows(pts, n_eff, w, mu, sigma, tile):
    return np.stack([emulate_row(p, ne, w, mu, sigma, tile)
                     for p, ne in zip(pts, n_eff)])


def _rows(rng, R, N, case):
    n_eff = {
        "unpadded": np.full((R,), N),
        "padded": rng.randint(4, N, size=(R,)),
        "zero": np.zeros((R,)),
        "last_row": np.full((R,), N - 1),
        "mixed": np.array([0, N - 1, N, 3, 17][:R]),
    }[case].astype(np.int32)
    pts = np.zeros((R, N, 3), f32)
    for r in range(R):
        real = min(int(n_eff[r]) + 1, N)
        pts[r, :real] = rng.uniform(-1, 1, size=(real, 3))
    return pts, n_eff


@pytest.mark.parametrize("tile", [8, 2])
@pytest.mark.parametrize("m", [3, 4, 10])
@pytest.mark.parametrize("case", ["unpadded", "padded", "zero", "last_row", "mixed"])
def test_kernel_scheme_matches_plain_and_jax(rng, case, m, tile):
    """The emulated kernel (tiles of 8 points, or the 2 of the wide
    instance that serves K > 512, as m = 10 gives; N = 45, so the last tile
    is partial) against the port's plain version and JAX's jnp reference,
    at atol 1e-5."""
    R, N = 5, 45
    w, mu, sigma = _gmm(m)
    pts, n_eff = _rows(rng, R, N, case)
    got = emulate_rows(pts, n_eff, w, mu, sigma, tile)
    t = torch.from_numpy
    plain = torch_mups.tdmfv_n_est_reference(t(pts), t(w), t(mu), t(sigma), t(n_eff)).numpy()
    want = np.asarray(tdmfv_n_est(jnp.asarray(pts), w, mu, sigma, jnp.asarray(n_eff),
                                  flatten=False))
    assert got.shape == plain.shape == (R, 20, m ** 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, plain, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16])
def test_warp_den_scatters_every_point(tile):
    """warp_den and tile_denominators give every point of the tile its
    denominator, whichever tile size: the sum over all Gaussians."""
    rng = np.random.RandomState(tile)
    wp = rng.uniform(0, 1, (tile, 3 * WARP)).astype(f32)
    got = tile_denominators(warp_den(wp))
    want = wp.astype(f64).sum(1).astype(f32)
    np.testing.assert_array_equal(got, want)


def test_flagship_row_matches_plain():
    """One flagship row (512 points, n_eff 300, 8^3 Gaussians: 16 warps)
    through the emulated kernel against the plain version."""
    w, mu, sigma = _gmm(8, 0.0156)
    pts = _flagship_rows(1)
    n_eff = np.array([300], np.int32)
    pts[0, 301:] = 0
    got = emulate_rows(pts, n_eff, w, mu, sigma, tile=8)
    t = torch.from_numpy
    plain = torch_mups.tdmfv_n_est_reference(t(pts), t(w), t(mu), t(sigma), t(n_eff)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5)


# ---- the order of the tickets -------------------------------------------------

MAX_WORK = (1 << 20) - 1


def sort_units(n_eff, rows_per_unit, N):
    """The kernel's sort_units: keys (MAX_WORK - work) << 12 | unit, padded
    to a power of two with 0xffffffff, through the same bitonic network."""
    units = len(n_eff) // rows_per_unit
    p = 1
    while p < units:
        p *= 2
    real = np.clip(np.minimum(n_eff, N - 1) + 1, 0, None).reshape(units, rows_per_unit)
    work = np.minimum(real.sum(1), MAX_WORK)
    keys = np.full(p, 0xFFFFFFFF, np.uint64)
    keys[:units] = ((MAX_WORK - work).astype(np.uint64) << 12) | np.arange(units, dtype=np.uint64)
    k = 2
    while k <= p:
        j = k // 2
        while j > 0:
            for i in range(p):
                partner = i ^ j
                if partner > i and (keys[i] > keys[partner]) == ((i & k) == 0):
                    keys[i], keys[partner] = keys[partner], keys[i]
            j //= 2
        k *= 2
    return (keys[:units] & 0xFFF).astype(np.int64), work


@pytest.mark.parametrize("R, rows_per_unit", [(1, 1), (5, 1), (384, 1), (768, 1), (768, 8),
                                              (96, 4)])
def test_tickets_hand_out_every_unit_longest_first(R, rows_per_unit):
    """Every unit (a row, or a group of block_b rows) gets exactly one ticket,
    in order of decreasing real points, ties by index: what a stable
    descending argsort gives."""
    rng = np.random.RandomState(R + rows_per_unit)
    N = 512
    n_eff = rng.randint(-1, N + 2, size=R)
    order, work = sort_units(n_eff, rows_per_unit, N)
    np.testing.assert_array_equal(np.sort(order), np.arange(R // rows_per_unit))
    np.testing.assert_array_equal(order, np.argsort(-work, kind="stable"))


# ---- the timing script's switches and its served rows --------------------------

@pytest.mark.parametrize("switch", ["PART_NO_EXP", "PART_NO_DIV", "PART_NO_SUMS", "PART_NO_DEN",
                                    "PART_NO_SORT", "PART_TILE"])
def test_kernel_parts_script_switches_the_current_source(switch):
    """`scripts/mups_kernel_parts.py` passes each of its switches to nvcc as
    a macro, the kernel source tests every one of them, and the library the
    port serves with is built without any."""
    from nestinet_tpu_torch.ops.kernels import build, mups_cuda
    from nestinet_tpu_torch.scripts import mups_kernel_parts

    flags = {f.split("=")[0] for v in mups_kernel_parts.VARIANTS.values() for f in v}
    assert f"-D{switch}" in flags
    with open(mups_cuda.KERNEL.source) as f:
        src = f.read()
    assert f"#ifdef {switch}" in src or f"#ifndef {switch}" in src
    assert not any(f.startswith("-DPART") for f in build.NVCC_FLAGS)


def test_served_rows_hold_pcpnet_density():
    """The timing script's served batch (and chip_smoke's): 256 patches x 3
    radii extracted from a 100,000-point synthetic shape, so that the widest
    radius fills all 512 points of most patches, as on PCPNet's shapes."""
    from nestinet_tpu_torch.scripts.mups_kernel_parts import served_rows

    points, n_eff = served_rows(torch.device("cpu"), seed=7)
    assert points.shape == (768, 512, 3) and n_eff.shape == (768,)
    assert n_eff.dtype == torch.int32 and torch.isfinite(points).all()
    by_radius = n_eff.reshape(256, 3).float()
    assert (by_radius[:, 2] >= 511).float().mean() > 0.9
    assert 150 < by_radius[:, 1].mean() < 400
    assert 10 < by_radius[:, 0].mean() < 60
    rows = torch.arange(512)[None, :]
    assert (points[rows > n_eff[:, None].long()] == 0).all()  # padded as the loader pads
