"""Batch assembly and host-side prefetch.

The serving part of `nestinet_tpu/data/loader.py` (every patch in order,
no targets), copied so that the port imports nothing of the JAX package.

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

from .dataset import PatchDataset, SequentialPatchSampler


def _stack_items(items: list[dict]) -> dict:
    batch = {}
    for key in items[0]:
        batch[key] = np.stack([it[key] for it in items])
    return batch


class BatchIterator:
    """Iterates dict batches over (dataset, sampler)."""

    def __init__(
        self,
        dataset: PatchDataset,
        sampler,
        batch_size: int,
        *,
        workers: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.workers = int(workers)
        self.prefetch = int(prefetch)
        self._pool = ThreadPoolExecutor(workers) if workers > 0 else None

    def __len__(self):
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, indices) -> dict:
        if self._pool is not None:
            items = list(self._pool.map(self.dataset.__getitem__, indices))
        else:
            items = [self.dataset[i] for i in indices]
        return _stack_items(items)

    def _batches(self):
        indices = []
        for idx in self.sampler:
            indices.append(int(idx))
            if len(indices) == self.batch_size:
                yield self._make_batch(indices)
                indices = []
        if indices:
            yield self._make_batch(indices)

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
    seed: int = 3627473,
    use_pca: bool = False,
    patch_center: str = "point",
    cache_capacity: int = 100,
    workers: int = 0,
    sparse_patches: bool = False,
    use_native: bool = True,
) -> tuple[BatchIterator, PatchDataset]:
    """The reference's loader factory (`provider.py:319-429`) in its
    serving form: the 'full' sample order and no targets."""
    dataset = PatchDataset(
        root=indir,
        shape_list_filename=dataset_name,
        patch_radius=list(patch_radius),
        points_per_patch=points_per_patch,
        seed=seed,
        use_pca=use_pca,
        center=patch_center,
        cache_capacity=cache_capacity,
        sparse_patches=sparse_patches,
        use_native=use_native,
    )
    loader = BatchIterator(dataset, SequentialPatchSampler(dataset), batch_size, workers=workers)
    return loader, dataset
