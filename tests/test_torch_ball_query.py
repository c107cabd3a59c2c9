"""The port's grid-hash ball query against the JAX package's, on the CPU.

The same numpy clouds, queries and seeds go through
`nestinet_tpu.ops.ball_query` and `nestinet_tpu_torch.ops.ball_query`.
Selection is integer work on identical float32 coordinates, so the bar is
exact equality: the grid's fields, `_mix32`, the candidate windows and the
selected rows, hit masks and n_eff, on the compaction path (T <= k), the
first-k draw and the seeded draw.  Extracted patch coordinates agree at
atol 1e-6, and the neighbour sets equal scipy cKDTree's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nestinet_tpu.infer import device_pipeline as jax_pipeline
from nestinet_tpu.ops import ball_query as jbq
from nestinet_tpu_torch.infer import device_pipeline
from nestinet_tpu_torch.ops import ball_query as tbq

torch.set_num_threads(1)


def _cloud(rng, m, scale=1.0):
    return (rng.uniform(-1, 1, size=(m, 3)) * scale).astype(np.float32)


def _grids(pts, radius, max_dim=64):
    return (jbq.build_grid(jnp.asarray(pts), radius, max_dim=max_dim),
            tbq.build_grid(torch.from_numpy(pts), radius, max_dim=max_dim))


@pytest.mark.parametrize("m,radius,max_dim", [(2000, 0.15, 64), (500, 0.3, 16),
                                              (50, 1.0, 64)])
def test_build_grid_fields_equal(rng, m, radius, max_dim):
    pts = _cloud(rng, m, scale=0.01 if radius == 1.0 else 1.0)
    want, got = _grids(pts, radius, max_dim)
    for field in jbq.HashGrid._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


def test_build_grid_sort_is_stable(rng):
    """Points of one cell keep their input order (jnp.argsort is stable)."""
    pts = _cloud(rng, 400)
    _, got = _grids(pts, 0.5)
    order, ids = got.order.numpy(), got.cell_ids.numpy()
    for c in np.unique(ids):
        assert np.all(np.diff(order[ids == c]) > 0)


def test_mix32_equal(rng):
    words = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint64),
        rng.randint(0, 2**32, size=4096, dtype=np.uint64),
    ])
    want = np.asarray(jbq._mix32(jnp.asarray(words.astype(np.uint32)))).astype(np.int64)
    got = tbq._mix32(torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_stable_descending_sort_breaks_ties_like_top_k():
    """The draw's top-k: among equal keys the lower index comes first."""
    import jax

    key = np.array([[3, 5, 5, 0, 5, 3, 1, 0]], np.int64)
    _, want = jax.lax.top_k(jnp.asarray(key.astype(np.int32)), 5)
    _, got = torch.sort(torch.from_numpy(key), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(got[:, :5].numpy(), np.asarray(want))


def _select_both(grid_j, grid_t, q, radius, *, k, seed, window_capacity,
                 cell_capacity=64):
    jseed = None if seed is None else jnp.uint32(seed)
    want = jbq._query_select(grid_j, jnp.asarray(q), radius, k=k,
                             cell_capacity=cell_capacity, seed=jseed,
                             window_capacity=window_capacity)
    got = tbq._query_select(grid_t, torch.from_numpy(q), radius, k=k,
                            cell_capacity=cell_capacity, seed=seed,
                            window_capacity=window_capacity)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


SELECT_CASES = {
    # name: (points, radius, k, seed, window) -- window None: per-cell lanes
    "compaction": (2000, 0.15, 256, None, "occupancy"),
    "compaction_seeded": (2000, 0.15, 256, 11, "occupancy"),
    "first_k": (3000, 0.3, 32, None, "occupancy"),
    "seeded": (3000, 0.3, 32, 7, "occupancy"),
    "seeded_high_seed": (3000, 0.3, 32, 0xFFFFFFF0, "occupancy"),
    "truncated_window": (2000, 0.3, 16, 5, "third"),
    "per_cell_lanes": (1500, 0.3, 32, 3, None),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_query_select_exactly_equal(rng, case):
    m, radius, k, seed, window = SELECT_CASES[case]
    pts = _cloud(rng, m)
    q = pts[rng.choice(m, 48, replace=False)]
    q[0] = pts.max(0)  # a query on the grid's upper corner
    grid_j, grid_t = _grids(pts, radius, max_dim=16)
    occ = jbq.max_window_occupancy(grid_j)
    assert tbq.max_window_occupancy(grid_t) == occ
    wcap = {"occupancy": occ, "third": max(8, occ // 3), None: None}[window]
    cell_cap = jbq.max_cell_occupancy(grid_j)
    want_w = jbq._candidate_window(grid_j, jnp.asarray(q), radius,
                                   cell_capacity=cell_cap, window_capacity=wcap)
    got_w = tbq._candidate_window(grid_t, torch.from_numpy(q), radius,
                                  cell_capacity=cell_cap, window_capacity=wcap)
    for name, w, g in zip(("cand", "cpts", "hit", "n_hits"), want_w, got_w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    want, got = _select_both(grid_j, grid_t, q, radius, k=k, seed=seed,
                             window_capacity=wcap, cell_capacity=cell_cap)
    for name, w, g in zip(("rows", "pts", "took_hit", "n_eff"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    jseed = None if seed is None else jnp.uint32(seed)
    want_s = jbq._ball_query_sorted(grid_j, jnp.asarray(q), radius, k=k, seed=jseed,
                                    cell_capacity=cell_cap, window_capacity=wcap)
    got_s = tbq._ball_query_sorted(grid_t, torch.from_numpy(q), radius, k=k, seed=seed,
                                   cell_capacity=cell_cap, window_capacity=wcap)
    for name, w, g in zip(("sorted rows", "took_hit", "n_eff"), want_s, got_s):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    T = got_w[2].shape[1]
    if case.startswith("compaction"):
        assert T <= k
    else:
        assert T > k and np.any(got[3] == k)  # some ball is oversized: a draw


def test_small_grid_clipped_cells_collide(rng):
    """A cloud much smaller than the radius: one cell, which all 27
    neighbour offsets clip onto; it must count once (tests/test_ball_query.py
    `test_small_grid_dedupes_clipped_cells`)."""
    pts = _cloud(rng, 50, scale=0.01)
    grid_j, grid_t = _grids(pts, 1.0)
    for seed, k in ((None, 64), (9, 16), (None, 16)):
        want, got = _select_both(grid_j, grid_t, pts[:4], 1.0, k=k, seed=seed,
                                 window_capacity=64)
        for name, w, g in zip(("rows", "pts", "took_hit", "n_eff"), want, got):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} seed={seed} k={k}")
        assert np.all(got[3] == min(50, k))


@pytest.mark.parametrize("seed", [None, 5])
def test_extract_patches_agrees(rng, seed):
    pts = _cloud(rng, 2000)
    q = pts[rng.choice(2000, 32, replace=False)]
    radius = 0.25
    grid_j, grid_t = _grids(pts, radius, max_dim=16)
    wcap = jbq.max_window_occupancy(grid_j)
    jseed = None if seed is None else jnp.uint32(seed)
    want_p, want_n = jbq.extract_patches(grid_j, jnp.asarray(q), radius, k=48,
                                         window_capacity=wcap, seed=jseed)
    got_p, got_n = tbq.extract_patches(grid_t, torch.from_numpy(q), radius, k=48,
                                       window_capacity=wcap, seed=seed)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6)


def test_neighbour_sets_match_scipy(rng):
    pts = _cloud(rng, 2000)
    q = pts[rng.choice(2000, 64, replace=False)]
    radius = 0.15
    want = cKDTree(pts).query_ball_point(q, radius)
    grid = tbq.build_grid(torch.from_numpy(pts), radius)
    assert tbq.max_cell_occupancy(grid) <= 64
    idx, n_eff = tbq.ball_query(grid, torch.from_numpy(q), radius, k=256)
    for i in range(q.shape[0]):
        got = set(idx[i, : n_eff[i]].tolist())
        assert len(got) == n_eff[i], "duplicate neighbour returned"
        assert got == set(want[i]), f"query {i} neighbour set mismatch"


def test_window_occupancy_np_matches_jax(rng):
    pts = _cloud(rng, 6000) * np.float32(1.1) - np.float32(0.2)
    bbdiag = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    for rf in (0.01, 0.03, 0.05, 0.2):
        assert tbq.window_occupancy_np(pts, rf * bbdiag) == jbq.window_occupancy_np(
            pts, rf * bbdiag)


def test_dataset_window_caps_equal(rng):
    clouds = [_cloud(rng, n, s) for n, s in ((3000, 1.0), (800, 0.3), (5000, 2.0))]
    radii = (0.01, 0.03, 0.05, 0.2)
    got = device_pipeline._dataset_window_caps(clouds, radii)
    assert got == jax_pipeline._dataset_window_caps(clouds, radii)
    assert [device_pipeline._capacity_bucket(o) for o in (0, 64, 65, 129)] == [64, 64, 128, 256]
