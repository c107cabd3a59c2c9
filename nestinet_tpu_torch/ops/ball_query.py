"""Fixed-radius neighbourhood search on the device (grid-hash ball query),
in plain PyTorch ops.

Counterpart of `nestinet_tpu/ops/ball_query.py`, which is plain XLA (no
Pallas kernel).  Every step keeps the JAX code's semantics, so that the
same cloud, queries and seed select the same neighbours, row for row:

  1. `build_grid` hashes the points into a uniform grid of cubic cells no
     smaller than the radius, sorts them by cell id with a STABLE sort (as
     `jnp.argsort`), and records a dense CSR row table over the cell ids
     (`searchsorted`, side="left").  The sorted row numbers feed the draw's
     hash keys, so another order among equal ids would draw other points.
  2. `_candidate_window` visits the 27 cells around each query (a cell
     that clipping visits twice counts once), lays their points out in
     `window_capacity` lanes (scatter-amax of each live segment's start,
     then a forward cummax), and tests the true distance.
  3. `_query_select` keeps every hit when the window fits in k lanes;
     otherwise the first k hits in lane order, or, with a seed, a uniform
     k-subset drawn by murmur3 hash keys.  JAX's `lax.top_k` puts the lower
     index first among equal keys; a stable descending sort followed by the
     first k does the same (`torch.topk` promises no order among ties).

The JAX code does its uint32 arithmetic with wraparound; here it is int64
with 0xFFFFFFFF masks (`_mix32`), and lane arithmetic that JAX lets wrap in
int32 is exact in int64.  Indices are int64; the grid's integer fields keep
JAX's int32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import profiling

_MASK32 = 0xFFFFFFFF
_NEG = -(2**31) + 1  # the JAX code's "no segment" value


class HashGrid(NamedTuple):
    """A uniform grid over a point cloud, on the cloud's device."""

    points: torch.Tensor  # [M, 3] float32, sorted by cell id
    order: torch.Tensor  # [M] int32 original indices of the sorted points
    cell_ids: torch.Tensor  # [M] int32 sorted cell id per point
    origin: torch.Tensor  # [3] float32 grid origin
    dims: torch.Tensor  # [3] int32 cells per axis
    cell_size: torch.Tensor  # [] float32 cell edge length
    cell_starts: torch.Tensor  # [max_dim^3 + 1] int32 CSR row table: cell
    # c's points are the sorted rows [cell_starts[c], cell_starts[c+1]).


def _cell_of(points, origin, cell_size, dims):
    ijk = torch.floor((points - origin) / cell_size).to(torch.int32)
    ijk = torch.minimum(torch.clamp(ijk, min=0), dims - 1)
    return (ijk[..., 0] * dims[1] + ijk[..., 1]) * dims[2] + ijk[..., 2]


def build_grid(points: torch.Tensor, radius, *, max_dim: int = 64) -> HashGrid:
    """Hash `points` [M, 3] into cubic cells of edge >= `radius`; at most
    `max_dim` cells per axis (cells only get coarser, never wrong: the
    query still tests the distance)."""
    points = points.to(torch.float32)
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    radius = profiling.upload("upload.radius", radius, points.device, torch.float32)
    dims = torch.clamp(
        torch.clamp(torch.ceil((hi - lo) / radius), min=1).to(torch.int32), max=max_dim
    )
    cell_size = torch.amax(torch.maximum((hi - lo) / dims.to(torch.float32), radius))
    dims = torch.clamp(torch.ceil((hi - lo) / cell_size).to(torch.int32), min=1)
    ids = _cell_of(points, lo, cell_size, dims)
    ids_sorted, order = torch.sort(ids, stable=True)
    table_ids = torch.arange(max_dim**3 + 1, dtype=torch.int32, device=points.device)
    cell_starts = torch.searchsorted(ids_sorted, table_ids, side="left")
    return HashGrid(
        points=points[order],
        order=order.to(torch.int32),
        cell_ids=ids_sorted,
        origin=lo,
        dims=dims,
        cell_size=cell_size,
        cell_starts=cell_starts.to(torch.int32),
    )


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the product is split into
    16-bit halves of c so that no partial product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 words held in int64 (JAX `_mix32`)."""
    x = x.to(torch.int64) & _MASK32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _neighbour_offsets(device) -> torch.Tensor:
    """The 27 cell offsets [27, 3] in the JAX code's (meshgrid "ij") order."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)


def _candidate_window(grid: HashGrid, queries, radius, *, cell_capacity: int,
                      window_capacity: int | None):
    """The 27-cell candidate window of each query.

    Returns:
        cand   [B, T] int64 rows into the SORTED cloud (0 where invalid),
        cpts   [B, T, 3] the candidates' coordinates,
        hit    [B, T] bool true-distance ball membership,
        n_hits [B] int64 exact ball population (uncapped).
    """
    dev = queries.device
    B = queries.shape[0]
    radius = profiling.upload("upload.radius", radius, dev, torch.float32)
    queries = queries.to(torch.float32)
    dims = grid.dims

    ijk = torch.floor((queries - grid.origin) / grid.cell_size).to(torch.int32)
    ncell = ijk[:, None, :] + _neighbour_offsets(dev)[None]  # [B, 27, 3]
    in_bounds = torch.all((ncell >= 0) & (ncell < dims), dim=-1)
    ncell = torch.minimum(torch.clamp(ncell, min=0), dims - 1)
    nids = (ncell[..., 0] * dims[1] + ncell[..., 1]) * dims[2] + ncell[..., 2]
    # A cell visited twice (clipping on small grids) counts at its first
    # visit only; out-of-bounds slots compare under distinct negative ids.
    sentinel = -1 - torch.arange(27, dtype=torch.int32, device=dev)
    nids_cmp = torch.where(in_bounds, nids, sentinel[None])
    earlier = torch.tril(torch.ones((27, 27), dtype=torch.bool, device=dev), diagonal=-1)
    eq_earlier = (nids_cmp[:, :, None] == nids_cmp[:, None, :]) & earlier[None]
    first_visit = ~torch.any(eq_earlier, dim=-1)

    tbl = grid.cell_starts.to(torch.int64)
    nc = torch.clamp(nids.to(torch.int64), 0, tbl.shape[0] - 2)
    starts = tbl[nc]
    counts = (tbl[nc + 1] - starts) * (in_bounds & first_visit)  # [B, 27]

    if window_capacity is not None:
        # Lane j of query b is the j-th point of b's window, the 27 cells'
        # segments concatenated in cell order.  Each live segment scatters
        # its start row and start position at its position; a forward
        # cummax fills the lanes in between (both values ascend along the
        # live segments).  A segment starting at or past the lane budget
        # goes to the spare column T and is cut off (JAX's mode="drop").
        T = int(window_capacity)
        cum = torch.cumsum(counts, dim=1)
        total = cum[:, -1:]
        p = torch.cat([torch.zeros((B, 1), dtype=cum.dtype, device=dev), cum[:, :-1]], dim=1)
        live = counts > 0
        col = torch.clamp(p, max=T)

        def fill(values):
            buf = torch.full((B, T + 1), _NEG, dtype=torch.int64, device=dev)
            buf.scatter_reduce_(1, col, torch.where(live, values, _NEG), "amax")
            return torch.cummax(buf[:, :T], dim=1).values

        startf, pf = fill(starts), fill(p)
        lane = torch.arange(T, dtype=torch.int64, device=dev)
        cand = startf + (lane[None] - pf)
        valid = lane[None] < total
        cand = torch.where(valid, cand, 0)
    else:
        lane = torch.arange(cell_capacity, dtype=torch.int64, device=dev)
        cand = starts[..., None] + lane[None, None]
        valid = lane[None, None] < torch.clamp(counts, max=cell_capacity)[..., None]
        cand = torch.where(valid, cand, 0).reshape(B, 27 * cell_capacity)
        valid = valid.reshape(B, 27 * cell_capacity)

    cpts = grid.points[cand]  # [B, T, 3]
    d = cpts - queries[:, None]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    hit = valid & (d2 <= radius * radius)
    n_hits = hit.sum(dim=1)
    return cand, cpts, hit, n_hits


def _take_lanes(cand, cpts, lanes):
    return (torch.gather(cand, 1, lanes),
            torch.gather(cpts, 1, lanes[:, :, None].expand(-1, -1, 3)))


def _query_select(grid: HashGrid, queries, radius, *, k: int, cell_capacity: int,
                  seed=None, window_capacity: int | None = None):
    """Candidate window, then a k-subset of each ball.

    Returns (rows [B, k] int64 into the SORTED cloud, pts [B, k, 3] the
    selected points' coordinates, took_hit [B, k] prefix mask, n_eff [B]
    int32); rows and pts are zero outside the prefix.  `seed` is a uint32
    (a Python int or a 0-d integer tensor).
    """
    cand, cpts, hit, n_hits = _candidate_window(
        grid, queries, radius, cell_capacity=cell_capacity,
        window_capacity=window_capacity,
    )
    dev = queries.device
    B, T = hit.shape
    n_eff = torch.clamp(n_hits, max=k).to(torch.int32)

    if T <= k:
        # The whole window fits in k lanes: every hit is kept, in lane
        # order (rows ascending), whatever the draw would have been.
        lane = torch.arange(T, dtype=torch.int64, device=dev)
        ordv = torch.where(hit, lane[None], lane[None] + T)
        lane_sel = torch.sort(ordv, dim=1).values
        lane_sel = torch.where(lane_sel < T, lane_sel, lane_sel - T)
        rows, pts = _take_lanes(cand, cpts, lane_sel)
        if T < k:
            rows = torch.nn.functional.pad(rows, (0, k - T))
            pts = torch.nn.functional.pad(pts, (0, 0, 0, k - T))
        took_hit = torch.arange(k, device=dev)[None] < n_eff[:, None]
    else:
        if seed is None:
            # first k hits in lane order: distinct descending keys T..1
            lane_key = torch.arange(T, 0, -1, dtype=torch.int64, device=dev)
            key = torch.where(hit, lane_key[None], 0)
        else:
            # a uniform k-subset per query: i.i.d. hash keys per (query,
            # candidate); keys are 30-bit, odd, and > 0 on hits only
            seed = profiling.upload("upload.seed", seed, dev, torch.int64)
            salt = torch.arange(B, dtype=torch.int64, device=dev) * 0x9E3779B9 + seed
            q_salt = _mix32(salt & _MASK32)
            h = _mix32(cand ^ q_salt[:, None])
            key = torch.where(hit, (h >> 2) | 1, 0)
        vals, take = torch.sort(key, dim=1, descending=True, stable=True)
        vals, take = vals[:, :k], take[:, :k]
        took_hit = vals > 0
        rows, pts = _take_lanes(cand, cpts, take)

    rows = torch.where(took_hit, rows, 0)
    pts = torch.where(took_hit[:, :, None], pts, 0.0)
    return rows, pts, took_hit, n_eff


def ball_query(grid: HashGrid, queries, radius, *, k: int, cell_capacity: int = 64,
               seed=None, window_capacity: int | None = None):
    """Fixed-radius neighbours of each query point [B, 3]: (idx [B, k]
    int64 into the ORIGINAL cloud, 0-padded; n_eff [B] int32, the true
    count clipped at k).  See the JAX `ball_query` for the options."""
    rows, _, took_hit, n_eff = _query_select(
        grid, queries, radius, k=k, cell_capacity=cell_capacity, seed=seed,
        window_capacity=window_capacity,
    )
    idx = torch.where(took_hit, grid.order.to(torch.int64)[rows], 0)
    return idx, n_eff


def _ball_query_sorted(grid: HashGrid, queries, radius, *, k: int, cell_capacity: int,
                       seed=None, window_capacity: int | None = None):
    """`ball_query` returning rows into the grid's SORTED points, with the
    hit mask: (rows [B, k], took_hit [B, k], n_eff [B])."""
    rows, _, took_hit, n_eff = _query_select(
        grid, queries, radius, k=k, cell_capacity=cell_capacity, seed=seed,
        window_capacity=window_capacity,
    )
    return rows, took_hit, n_eff


def extract_patches(grid: HashGrid, queries, radius, *, k: int, cell_capacity: int = 64,
                    center: str = "point", seed=None, window_capacity: int | None = None):
    """Ball query, then the reference's patch post-processing: the
    selected points, centred at the query point (or the patch mean),
    scaled by 1/radius, zero past n_eff.

    Returns (patch_points [B, k, 3] float32, n_eff [B] int32).
    """
    _, pts, took_hit, n_eff = _query_select(
        grid, queries, radius, k=k, cell_capacity=cell_capacity, seed=seed,
        window_capacity=window_capacity,
    )
    mask = took_hit[..., None]
    radius = profiling.upload("upload.radius", radius, queries.device, torch.float32)
    if center == "point":
        pts = pts - queries.to(torch.float32)[:, None]
    elif center == "mean":
        denom = torch.clamp(n_eff[:, None, None], min=1).to(torch.float32)
        pts = pts - torch.sum(torch.where(mask, pts, 0.0), dim=1, keepdim=True) / denom
    return torch.where(mask, pts / radius, 0.0), n_eff


def max_cell_occupancy(grid: HashGrid) -> int:
    """The largest point count of any cell (a `cell_capacity` below it can
    drop candidates)."""
    ids = grid.cell_ids.cpu().numpy()
    if ids.size == 0:
        return 0
    return int(np.unique(ids, return_counts=True)[1].max())


def _max_window_from_ids(ids: np.ndarray, dims: tuple) -> int:
    """Max 3x3x3-window population of a binned cloud: a 3-tap sliding sum
    of the per-cell counts along each axis (zero-padded at the boundary,
    as the query masks out-of-bounds cells), then the max."""
    counts = np.bincount(ids, minlength=int(np.prod(dims))).reshape(dims)
    s = counts.astype(np.int64)
    for ax in range(3):
        p = np.pad(s, [(1, 1) if a == ax else (0, 0) for a in range(3)])
        s = (
            np.take(p, range(0, dims[ax]), axis=ax)
            + np.take(p, range(1, dims[ax] + 1), axis=ax)
            + np.take(p, range(2, dims[ax] + 2), axis=ax)
        )
    return int(s.max())


def max_window_occupancy(grid: HashGrid) -> int:
    """The largest point count of any 3x3x3 cell window: the lane budget
    `window_capacity` needs so that no window point is dropped."""
    ids = grid.cell_ids.cpu().numpy()
    if ids.size == 0:
        return 0
    return _max_window_from_ids(ids, tuple(int(d) for d in grid.dims.cpu()))


def window_occupancy_np(points: np.ndarray, radius: float, *, max_dim: int = 64) -> int:
    """`max_window_occupancy` from the cloud alone, in NumPy: `build_grid`'s
    binning in the same float32 arithmetic, then the sliding-window max."""
    pts = np.asarray(points, np.float32)
    if pts.size == 0:
        return 0
    lo = pts.min(0)
    hi = pts.max(0)
    radius = np.float32(radius)
    dims = np.minimum(np.maximum(np.ceil((hi - lo) / radius), 1).astype(np.int32), max_dim)
    cell = np.float32(np.max(np.maximum((hi - lo) / dims.astype(np.float32), radius)))
    dims = np.maximum(np.ceil((hi - lo) / cell).astype(np.int32), 1)
    ijk = np.clip(np.floor((pts - lo) / cell).astype(np.int32), 0, dims - 1)
    ids = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    return _max_window_from_ids(ids, tuple(int(d) for d in dims))
