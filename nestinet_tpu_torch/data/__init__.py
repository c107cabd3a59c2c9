"""Host patch pipeline (the serving part of the JAX package's host modules)."""

from .dataset import PatchDataset, SequentialPatchSampler  # noqa: F401
from .loader import BatchIterator, get_data_loader  # noqa: F401
