"""ModelNet40-style HDF5 point-cloud loaders.

A copy of `nestinet_tpu/data/modelnet.py`, so that the port imports nothing
of the JAX package.  The loaders read HDF5 through h5py, imported when
they are called; without it they raise ImportError.  The rest is numpy.

Capability parity with the legacy classification loaders the reference
carried in `utils/provider.py:206-315` (shuffle, per-file h5 IO, list
files, batched label/data access).  Not used by the normal-estimation
path — provided as library functions so 3DmFV-Net-style classification
experiments (the FV variants in `ops/mups.py`) have their data side.
"""

from __future__ import annotations

import os

import numpy as np


def shuffle_data(data: np.ndarray, labels: np.ndarray, seed: int | None = None):
    """Shuffle data and labels together; returns (data, labels, idx)
    (parity: `provider.py:206-217`)."""
    idx = np.arange(len(labels))
    np.random.RandomState(seed).shuffle(idx)
    return data[idx, ...], labels[idx], idx


def _h5py():
    """h5py, imported at call time, or an ImportError that names it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the ModelNet loaders read HDF5 through h5py, which is not installed "
            "(ROADMAP.md queue 1, item 4: what waits for a library the card lacks)") from e
    return h5py


def load_h5(path: str):
    """(data, label) arrays from an h5 file (parity: `provider.py:286-292`)."""
    with _h5py().File(path, "r") as f:
        data = f["data"][:]
        label = f["label"][:]
    return data, label


def load_h5_with_normals(path: str):
    """(data, label, normal) — parity: `provider.py:301-309`."""
    with _h5py().File(path, "r") as f:
        return f["data"][:], f["label"][:], f["normal"][:]


def load_h5_with_seg(path: str):
    """(data, label, seg) for part-segmentation h5 files
    (parity: `provider.py:294-299`)."""
    with _h5py().File(path, "r") as f:
        return f["data"][:], f["label"][:], f["pid"][:]


def get_data_files(list_filename: str) -> list[str]:
    """Read an h5 file-list manifest (parity: `provider.py:281-284`);
    entries are resolved relative to the manifest's directory."""
    base = os.path.dirname(os.path.abspath(list_filename))
    with open(list_filename) as f:
        names = [line.strip() for line in f if line.strip()]
    return [n if os.path.isabs(n) else os.path.join(base, n) for n in names]


def iter_batches(data: np.ndarray, labels: np.ndarray, batch_size: int,
                 *, shuffle: bool = True, seed: int | None = None,
                 drop_last: bool = True):
    """Yield (data[b], labels[b]) minibatches — the loop the reference
    trainers hand-rolled around `provider.py` loaders."""
    if shuffle:
        data, labels, _ = shuffle_data(data, labels, seed)
    n = len(labels)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        yield data[i : i + batch_size], labels[i : i + batch_size]
