"""kd-tree patch dataset and samplers (host side).

A copy of `nestinet_tpu/data/dataset.py`, so that the port imports nothing
of the JAX package: the three sample orders, epochs, density augmentation
(`point_count_std`) and the normal and noise targets.  Point tuples and
the curvature targets are left out (no ported model reads them).  For
every case kept, the batches are the original's to the bit.

Capability parity with `utils/pcpnet_dataset.py`: multi-radius ball
queries around query points, random subsampling to a fixed patch size,
zero padding with effective-count bookkeeping, centering and 1/radius
scaling, optional per-patch PCA alignment and an LRU shape cache.  The
output arrays have fixed shapes: [n_scales * points_per_patch, 3] points
+ [n_scales] counts.

Deliberate non-copies: counts are int32 (the reference's uint16 capped
patches at 65535 points, `experts_n_est.py:35`); PCA uses numpy SVD
instead of torch.
"""

from __future__ import annotations

import numpy as np

from .pcpnet import load_shape, read_noise_levels, read_shape_list


class LRUCache:
    """Least-recently-used cache (parity: pcpnet_dataset.py:151-176)."""

    def __init__(self, capacity: int, loadfunc):
        self.capacity = max(1, capacity)
        self.loadfunc = loadfunc
        self.elements = {}
        self.used_at = {}
        self.counter = 0

    def get(self, key):
        if key not in self.elements:
            if len(self.elements) >= self.capacity:
                evict = min(self.used_at, key=self.used_at.get)
                del self.elements[evict]
                del self.used_at[evict]
            self.elements[key] = self.loadfunc(key)
        self.used_at[key] = self.counter
        self.counter += 1
        return self.elements[key]


class PatchDataset:
    """Multi-scale patch dataset over a PCPNet shape list.

    Args mirror the reference constructor (`pcpnet_dataset.py:182-282`):
        root, shape_list_filename, patch_radius (list of bbox-diagonal
        fractions), points_per_patch, features (subset of
        {'normal','noise'}), seed, identical_epochs, use_pca, center
        ('point'|'mean'|'none'), point_count_std, cache_capacity,
        sparse_patches.
    """

    def __init__(
        self,
        root: str,
        shape_list_filename: str,
        patch_radius,
        points_per_patch: int,
        seed: int,
        features=(),
        identical_epochs: bool = False,
        use_pca: bool = False,
        center: str = "point",
        point_count_std: float = 0.0,
        cache_capacity: int = 100,
        sparse_patches: bool = False,
        use_native: bool = True,
    ):
        self.root = root
        self.shape_list_filename = shape_list_filename
        self.patch_radius = list(patch_radius)
        self.points_per_patch = int(points_per_patch)
        self.features = tuple(features)
        unknown = set(self.features) - {"normal", "noise"}
        if unknown:
            raise ValueError(f"features not ported: {sorted(unknown)}")
        self.seed = int(seed)
        self.identical_epochs = identical_epochs
        self.use_pca = use_pca
        self.center = center
        self.point_count_std = float(point_count_std)
        self.sparse_patches = sparse_patches
        self.include_normals = "normal" in self.features
        self.include_noise = "noise" in self.features
        self.epoch = 0

        # The C++ kd-tree engine covers the default hot path (no PCA, no
        # density augmentation); other paths fall back to scipy/numpy.
        if use_native:
            from . import native as _native

            use_native = _native.available()
        self.use_native = use_native and not use_pca and self.point_count_std == 0.0

        self.shape_names = read_shape_list(root, shape_list_filename)
        self.noise_levels = read_noise_levels(root, shape_list_filename, len(self.shape_names))
        self.shape_cache = LRUCache(cache_capacity, self._load_shape_by_index)

        # Per-shape patch counts and absolute radii (fraction x bbox diag).
        self.shape_patch_count = []
        self.patch_radius_absolute = []
        for shape_ind in range(len(self.shape_names)):
            shape = self.shape_cache.get(shape_ind)
            if shape.pidx is None:
                self.shape_patch_count.append(shape.pts.shape[0])
            else:
                self.shape_patch_count.append(len(shape.pidx))
            diag = shape.bbox_diag
            self.patch_radius_absolute.append(
                [diag * rad for rad in self.patch_radius]
            )
        self._offsets = np.concatenate(
            [[0], np.cumsum(self.shape_patch_count)]
        ).astype(np.int64)

    # ---- shape management ----
    def _load_shape_by_index(self, shape_ind: int):
        shape = load_shape(
            self.root, self.shape_names[shape_ind], with_normals=self.include_normals,
            with_pidx=self.sparse_patches, noise_level=self.noise_levels[shape_ind],
        )
        if self.use_native:
            from .native import NativePatchSampler

            shape.native = NativePatchSampler(shape.pts)
        return shape

    def shape_index(self, global_index: int) -> tuple[int, int]:
        """global patch index -> (shape index, patch index within shape)."""
        shape_ind = int(np.searchsorted(self._offsets, global_index, side="right")) - 1
        return shape_ind, int(global_index - self._offsets[shape_ind])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch subsample stream (no effect when
        `identical_epochs` is set)."""
        self.epoch = int(epoch)

    def _item_seed(self, index: int) -> int:
        """Per-item seed: thread-safe (each worker gets its own stream) and
        reproducible.  `identical_epochs` pins the stream to the patch
        index alone (parity: pcpnet_dataset.py:307-308); otherwise the
        epoch is mixed in so subsampled subsets differ across epochs."""
        if self.identical_epochs:
            return (self.seed + index) % (2 ** 32)
        return (self.seed + 1000003 * self.epoch + index) % (2 ** 32)

    def _targets(self, item: dict, shape, center_ind: int, trans) -> dict:
        if self.include_normals:
            normal = shape.normals[center_ind].astype(np.float32)
            item["normals"] = normal if trans is None else normal @ trans
        if self.include_noise:
            item["noise"] = np.float32(shape.noise_level)
        return item

    # ---- the per-patch hot path ----
    def __getitem__(self, index: int) -> dict:
        shape_ind, patch_ind = self.shape_index(index)
        shape = self.shape_cache.get(shape_ind)
        if shape.pidx is None:
            center_ind = patch_ind
        else:
            center_ind = int(shape.pidx[patch_ind])
        center_point = shape.pts[center_ind]

        n_scales = len(self.patch_radius)
        N = self.points_per_patch

        if self.use_native and shape.native is not None:
            # C++ fast path: query + subsample + pad + center + scale in
            # one native call (deterministic in the item seed).
            pts, n_eff2 = shape.native.sample_patches(
                np.asarray([center_ind], dtype=np.int64),
                np.asarray(self.patch_radius_absolute[shape_ind], np.float32),
                N,
                seed=self._item_seed(index),
                center=self.center,
            )
            item = {"points": pts[0], "n_eff": n_eff2[0], "trans": np.eye(3, dtype=np.float32)}
            return self._targets(item, shape, center_ind, None)

        patch_pts = np.zeros((n_scales * N, 3), dtype=np.float32)
        n_eff = np.zeros((n_scales,), dtype=np.int32)
        valid_rows = []
        rng = np.random.RandomState(self._item_seed(index))

        for s, rad in enumerate(self.patch_radius_absolute[shape_ind]):
            inds = np.array(
                shape.kdtree.query_ball_point(center_point, rad), dtype=np.int64
            )

            count = min(N, len(inds))
            n_eff[s] = count

            # Density augmentation (parity: :315-317).
            if self.point_count_std > 0:
                count = max(
                    5,
                    int(round(count * rng.uniform(1.0 - self.point_count_std * 2))),
                )
                count = min(count, len(inds))

            if count < len(inds):
                inds = inds[rng.choice(len(inds), count, replace=False)]

            start = s * N
            end = start + count
            valid_rows.extend(range(start, end))
            sel = shape.pts[inds].astype(np.float32)

            # Centering (only valid rows — padded zeros stay zero).
            if self.center == "mean":
                sel = sel - sel.mean(0)
            elif self.center == "point":
                sel = sel - center_point
            elif self.center != "none":
                raise ValueError(f"unknown patch centering: {self.center}")

            patch_pts[start:end] = sel / rad

        if self.use_pca:
            valid = np.asarray(valid_rows, dtype=np.int64)
            pts_mean = patch_pts[valid].mean(0)
            centered = patch_pts[valid] - pts_mean
            # trans columns = principal directions (parity with torch.svd
            # of the transposed patch, :357-374).
            u, _, _ = np.linalg.svd(centered.T, full_matrices=False)
            trans = u.astype(np.float32)
            rotated = centered @ trans
            cp_new = (-pts_mean) @ trans
            patch_pts[valid] = rotated - cp_new
        else:
            trans = np.eye(3, dtype=np.float32)
        item = {"points": patch_pts, "n_eff": n_eff, "trans": trans}
        return self._targets(item, shape, center_ind, trans if self.use_pca else None)


class SequentialPatchSampler:
    """Every patch of every shape, in order ('full' sample order)."""

    def __init__(self, dataset: PatchDataset):
        self.dataset = dataset
        self.total = sum(dataset.shape_patch_count)

    def __iter__(self):
        return iter(range(self.total))

    def __len__(self):
        return self.total


class RandomPatchSampler:
    """Global no-replacement choice of sum(min(patches_per_shape, count))
    patches ('random' sample order)."""

    def __init__(self, dataset, patches_per_shape, seed=None, identical_epochs=False):
        self.dataset = dataset
        self.patches_per_shape = patches_per_shape
        self.identical_epochs = identical_epochs
        self.seed = int(seed) if seed is not None else np.random.randint(0, 2 ** 31 - 1)
        self.rng = np.random.RandomState(self.seed)
        self.total = sum(
            min(patches_per_shape, c) for c in dataset.shape_patch_count
        )

    def __iter__(self):
        if self.identical_epochs:
            self.rng.seed(self.seed)
        return iter(
            self.rng.choice(
                sum(self.dataset.shape_patch_count), size=self.total, replace=False
            )
        )

    def __len__(self):
        return self.total


class SequentialShapeRandomPatchSampler:
    """Random patches, but patches of one shape stay consecutive
    ('random_shape_consecutive' sample order)."""

    def __init__(
        self,
        dataset,
        patches_per_shape,
        seed=None,
        sequential_shapes=False,
        identical_epochs=False,
    ):
        self.dataset = dataset
        self.patches_per_shape = patches_per_shape
        self.sequential_shapes = sequential_shapes
        self.identical_epochs = identical_epochs
        self.seed = int(seed) if seed is not None else np.random.randint(0, 2 ** 31 - 1)
        self.rng = np.random.RandomState(self.seed)
        self.total = sum(
            min(patches_per_shape, c) for c in dataset.shape_patch_count
        )
        self.shape_patch_inds = None

    def __iter__(self):
        if self.identical_epochs:
            self.rng.seed(self.seed)
        counts = self.dataset.shape_patch_count
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        shape_inds = np.arange(len(counts))
        if not self.sequential_shapes:
            shape_inds = self.rng.permutation(shape_inds)
        self.shape_patch_inds = [[] for _ in counts]
        order = []
        for si in shape_inds:
            start, end = int(offsets[si]), int(offsets[si] + counts[si])
            chosen = self.rng.choice(
                np.arange(start, end),
                size=min(self.patches_per_shape, end - start),
                replace=False,
            )
            order.extend(chosen.tolist())
            self.shape_patch_inds[si] = chosen - start
        return iter(order)

    def __len__(self):
        return self.total
