"""The port's serving in bfloat16 with BatchNorm folded against the JAX package's, end to
end on the CPU: host routed, host dense and device routed, with the checks
and bars of `tests/test_torch_serve_bf16.py` (BF16_BARS).
"""

import pytest
import torch

from .test_torch_serve_bf16 import BF16_BARS, PATHS, check_against_jax, serve_both
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return serve_both(tmp_path_factory, "fold", "bfloat16", True)


@pytest.mark.parametrize("path", PATHS)
def test_fold_serving_matches_jax(served, path):
    data, out = served
    check_against_jax(data, *out[path], "bfloat16", True, BF16_BARS)
