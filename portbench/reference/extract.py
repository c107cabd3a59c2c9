"""Patch extraction of the reference, in NumPy: the seeded ball-query draw
that the device serving path specifies, worked out again point by point.

For each shape of a test list, in list order, a host generator
`RandomState(serve_seed)` draws the shape's permutation and then its salt
(`randint(0, 2**31)`).  Per radius (fraction x the shape's bounding-box
diagonal), the permuted cloud is binned into cubic cells of edge at least
the radius (at most 64 a side) and stably sorted by cell id; a query's
candidates are the points of the 27 cells around its own cell, cell by
cell in (i, j, k) offset order, a cell visited twice counting once, cut at
the lane budget (the list's largest 3 x 3 x 3 window population, rounded
up to a multiple of 128, at least 64).  A candidate within the radius
(float32 squared distance, summed x, y, then z) is a hit.  At most k hits
are kept: all of them when they fit, else the k with the largest keys
(murmur3 fmix32 of the sorted row XOR a per-query salt, shifted right by
2, with the low bit set), the lower lane first among equal keys.  The
query at index q of a shape lies in the batch starting at s = q - q mod B,
at row b = q - s; its salt is fmix32(b * 0x9E3779B9 + seed), with seed =
(shape salt + s + 0x85EBCA6B * radius index) mod 2^32.  The patch is the
kept points minus the query, divided by the radius, zero past n_eff.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
RADIUS_STEP = 0x85EBCA6B
ROW_STEP = 0x9E3779B9
MAX_DIM = 64
OFFSETS = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(27, 3)


def fmix32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64) & np.uint64(M32)
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) & np.uint64(M32)
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) & np.uint64(M32)
    return x ^ (x >> np.uint64(16))


def _binning(pts: np.ndarray, radius: float):
    """(origin, cell size, dims, cell id per point) in float32 arithmetic."""
    lo, hi = pts.min(0), pts.max(0)
    r = np.float32(radius)
    dims = np.minimum(np.maximum(np.ceil((hi - lo) / r), 1).astype(np.int32), MAX_DIM)
    cell = np.float32(np.max(np.maximum((hi - lo) / dims.astype(np.float32), r)))
    dims = np.maximum(np.ceil((hi - lo) / cell).astype(np.int32), 1)
    ijk = np.clip(np.floor((pts - lo) / cell).astype(np.int32), 0, dims - 1)
    ids = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    return lo, cell, dims, ids


def window_population(pts: np.ndarray, radius: float) -> int:
    """The largest number of points in any 3 x 3 x 3 block of cells."""
    _, _, dims, ids = _binning(pts, radius)
    s = np.bincount(ids, minlength=int(np.prod(dims))).reshape(dims).astype(np.int64)
    for ax in range(3):
        p = np.pad(s, [(1, 1) if a == ax else (0, 0) for a in range(3)])
        s = sum(np.take(p, range(o, dims[ax] + o), axis=ax) for o in range(3))
    return int(s.max())


def lane_budgets(clouds, radii_frac) -> list:
    out = []
    for i, rf in enumerate(radii_frac):
        occ = max(window_population(c, rf * float(np.linalg.norm(c.max(0) - c.min(0))))
                  for c in clouds)
        out.append(64 if occ <= 64 else -(-occ // 128) * 128)
    return out


class ShapeGrid:
    """One radius's binning of one permuted cloud."""

    def __init__(self, shuffled: np.ndarray, radius: float):
        self.radius = np.float32(radius)
        self.origin, self.cell, self.dims, ids = _binning(shuffled, radius)
        order = np.argsort(ids, kind="stable")
        self.points = shuffled[order]
        self.starts = np.searchsorted(ids[order], np.arange(MAX_DIM ** 3 + 1), side="left")

    def patch(self, q: np.ndarray, k: int, budget: int, seed: int, row: int):
        """(points [k, 3] float32, n_eff) of query point q [3] float32."""
        ijk = np.floor((q - self.origin) / self.cell).astype(np.int32)
        cells = ijk[None] + OFFSETS
        inside = np.all((cells >= 0) & (cells < self.dims), axis=1)
        cells = np.minimum(np.maximum(cells, 0), self.dims - 1)
        ids = (cells[:, 0] * self.dims[1] + cells[:, 1]) * self.dims[2] + cells[:, 2]
        lanes, seen = [], set()
        for c, ok in zip(ids.tolist(), inside.tolist()):
            if ok and c not in seen:
                seen.add(c)
                lanes.append(np.arange(self.starts[c], self.starts[c + 1]))
        cand = np.concatenate(lanes)[:budget] if lanes else np.zeros(0, np.int64)
        d = self.points[cand] - q
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        hits = cand[d2 <= self.radius * self.radius]
        if hits.shape[0] > k:
            salt = fmix32((row * ROW_STEP + seed) & M32)
            key = (fmix32(hits.astype(np.uint64) ^ salt) >> np.uint64(2)) | np.uint64(1)
            hits = hits[np.argsort(-key.astype(np.int64), kind="stable")[:k]]
        out = np.zeros((k, 3), np.float32)
        out[:hits.shape[0]] = (self.points[hits] - q) / self.radius
        return out, hits.shape[0]


def extract(clouds, queries_per_shape, picks, cfg: dict, serve_seed: int, batch: int):
    """Patches of the picked queries.

    clouds: [n_i, 3] float32 per shape of the list, as the program reads
    them; queries_per_shape: each shape's query indices into its cloud;
    picks: [(shape index, query index)].  Returns (points [P, S, k, 3]
    float32, n_eff [P, S] int64) in pick order."""
    radii_frac, k = cfg["patch_radius"], cfg["num_point"]
    budgets = lane_budgets(clouds, radii_frac)
    rng = np.random.RandomState(serve_seed)
    draws = []
    for cloud in clouds:
        perm = rng.permutation(cloud.shape[0])
        draws.append((perm, int(rng.randint(0, 2 ** 31))))
    pts = np.zeros((len(picks), len(radii_frac), k, 3), np.float32)
    n_eff = np.zeros((len(picks), len(radii_frac)), np.int64)
    grids = {}
    for p, (si, qi) in enumerate(picks):
        cloud = clouds[si]
        perm, salt = draws[si]
        if si not in grids:
            bbdiag = float(np.linalg.norm(cloud.max(0) - cloud.min(0)))
            grids[si] = [ShapeGrid(cloud[perm], rf * bbdiag) for rf in radii_frac]
        q = cloud[queries_per_shape[si][qi]]
        start = qi - qi % batch
        for r, g in enumerate(grids[si]):
            seed = (salt + start + RADIUS_STEP * r) & M32
            pts[p, r], n_eff[p, r] = g.patch(q, k, budgets[r], seed, qi - start)
    return pts, n_eff
