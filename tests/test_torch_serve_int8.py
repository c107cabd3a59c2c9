"""The port's serving in int8 against the JAX package's, end to
end on the CPU: host routed, host dense and device routed, with the checks
and bars of `tests/test_torch_serve_bf16.py` (INT8_BARS).
"""

import pytest
import torch

from .test_torch_serve_bf16 import INT8_BARS, PATHS, check_against_jax, serve_both
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return serve_both(tmp_path_factory, "int8", "int8", False)


@pytest.mark.parametrize("path", PATHS)
def test_int8_serving_matches_jax(served, path):
    data, out = served
    check_against_jax(data, *out[path], "int8", False, INT8_BARS)
