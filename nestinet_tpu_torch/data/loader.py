"""Batch assembly and host-side prefetch.

A copy of `nestinet_tpu/data/loader.py` (without point tuples and the
curvature targets), so that the port imports nothing of the JAX package.
Its defaults serve: the 'full' order and no targets; the trainer asks
for the 'random' order, normals and `drop_last`.

Replaces the reference's torch DataLoader usage (`utils/provider.py:319-429`)
with a numpy-native iterator.  Two improvements over the reference's
`workers=0` single-threaded loop (its main bottleneck, SURVEY §2.7):
  * patch extraction is fanned out over a thread pool (scipy's cKDTree
    releases the GIL during queries);
  * an optional background prefetch queue keeps `prefetch` batches ready
    so the accelerator never waits on the kd-tree.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .dataset import (
    PatchDataset,
    RandomPatchSampler,
    SequentialPatchSampler,
    SequentialShapeRandomPatchSampler,
)


SHARD_KINDS = ("rows", "batches")


def _stack_items(items: list[dict]) -> dict:
    batch = {}
    for key in items[0]:
        batch[key] = np.stack([it[key] for it in items])
    return batch


class BatchIterator:
    """Iterates dict batches over (dataset, sampler).

    `shard` = (rank, ranks, kind) makes this a data-parallel rank's loader:
    every rank walks the whole sampler (the index sequence is cheap) and
    extracts only its own items, which equal the one-process loader's
    (their seeds depend on the item alone, `PatchDataset._item_seed`):
      * "rows" (training): this rank's contiguous rows of every global
        batch of `batch_size` (`train/distributed.py::host_batch_slice`);
        needs `drop_last` and a batch size that divides by `ranks`;
      * "batches" (serving): the whole global batches i with
        i % ranks == rank, in order.
    """

    def __init__(
        self,
        dataset: PatchDataset,
        sampler,
        batch_size: int,
        *,
        workers: int = 0,
        prefetch: int = 2,
        drop_last: bool = False,
        shard: tuple[int, int, str] | None = None,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.workers = int(workers)
        self.prefetch = int(prefetch)
        self.drop_last = drop_last
        if shard is not None:
            rank, ranks, kind = shard
            if kind not in SHARD_KINDS or not 0 <= rank < ranks:
                raise ValueError(f"bad shard {shard}: (rank, ranks, one of {SHARD_KINDS})")
            if kind == "rows" and (self.batch_size % ranks or not drop_last):
                raise ValueError(f"row shards need drop_last and a batch size that divides "
                                 f"by {ranks}, got {self.batch_size}")
        self.shard = shard
        self._pool = ThreadPoolExecutor(workers) if workers > 0 else None

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            n = n // self.batch_size
        else:
            n = (n + self.batch_size - 1) // self.batch_size
        if self.shard is not None and self.shard[2] == "batches":
            return len(range(self.shard[0], n, self.shard[1]))
        return n

    def _make_batch(self, indices) -> dict:
        if self._pool is not None:
            items = list(self._pool.map(self.dataset.__getitem__, indices))
        else:
            items = [self.dataset[i] for i in indices]
        return _stack_items(items)

    def _mine(self, i: int, indices: list) -> list:
        """This rank's indices of global batch i."""
        if self.shard is None:
            return indices
        rank, ranks, kind = self.shard
        if kind == "batches":
            return indices if i % ranks == rank else []
        per = len(indices) // ranks
        return indices[rank * per:(rank + 1) * per]

    def _batches(self):
        indices, i = [], 0
        for idx in self.sampler:
            indices.append(int(idx))
            if len(indices) == self.batch_size:
                mine = self._mine(i, indices)
                if mine:
                    yield self._make_batch(mine)
                indices, i = [], i + 1
        if indices and not self.drop_last:
            mine = self._mine(i, indices)
            if mine:
                yield self._make_batch(mine)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []

        def producer():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as e:  # surface in consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is sentinel:
                break
            yield batch
        t.join()
        if error:
            raise error[0]


def get_data_loader(
    dataset_name: str,
    *,
    indir: str,
    batch_size: int = 64,
    patch_radius=(0.05,),
    points_per_patch: int = 500,
    outputs=(),
    patch_point_count_std: float = 0.0,
    seed: int = 3627473,
    identical_epochs: bool = False,
    use_pca: bool = False,
    patch_center: str = "point",
    cache_capacity: int = 100,
    patches_per_shape: int = 1000,
    patch_sample_order: str = "full",
    workers: int = 0,
    sparse_patches: bool = False,
    drop_last: bool = False,
    use_native: bool = True,
    shard: tuple[int, int, str] | None = None,
) -> tuple[BatchIterator, PatchDataset]:
    """Mirror of the reference's loader factory (`provider.py:319-429`).

    `outputs` uses the reference vocabulary: 'unoriented_normals' /
    'oriented_normals' -> normal targets, 'noise'.  `shard`: a
    data-parallel rank's part (`BatchIterator`).
    """
    features = []
    for o in outputs:
        if o in ("unoriented_normals", "oriented_normals"):
            if "normal" not in features:
                features.append("normal")
        elif o == "noise":
            features.append(o)
        else:
            raise ValueError(f"unknown or unported output: {o}")

    dataset = PatchDataset(
        root=indir,
        shape_list_filename=dataset_name,
        patch_radius=list(patch_radius),
        points_per_patch=points_per_patch,
        features=features,
        point_count_std=patch_point_count_std,
        seed=seed,
        identical_epochs=identical_epochs,
        use_pca=use_pca,
        center=patch_center,
        cache_capacity=cache_capacity,
        sparse_patches=sparse_patches,
        use_native=use_native,
    )

    if patch_sample_order == "random":
        sampler = RandomPatchSampler(
            dataset, patches_per_shape, seed=seed, identical_epochs=identical_epochs
        )
    elif patch_sample_order == "random_shape_consecutive":
        sampler = SequentialShapeRandomPatchSampler(
            dataset, patches_per_shape, seed=seed, identical_epochs=identical_epochs
        )
    elif patch_sample_order == "full":
        sampler = SequentialPatchSampler(dataset)
    else:
        raise ValueError(f"unknown patch sample order: {patch_sample_order}")

    loader = BatchIterator(
        dataset, sampler, batch_size, workers=workers, drop_last=drop_last, shard=shard
    )
    return loader, dataset
