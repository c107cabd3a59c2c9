"""The committed trained MoE run dir (`tests/test_torch_quality_fixture.py`)
served by the port on the CPU with device extraction, routed, in int8 and
int8 with BatchNorm folded: each testset's RMS within `BAR_DEG` (0.1 deg)
of JAX's host-dense float32 anchor and within `SAME_MODE_BAR_DEG` (0.01
deg) of JAX's same mode, as `chip_smoke.py` phase 18a holds the
card (`check_anchor_bar`).  The modes share their plain MuPS statistics
(`statistics_reused`).
"""

import pytest
import torch

from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401
from tests.test_torch_quality_fixture import check_anchor_bar, serve_modes

torch.set_num_threads(2)
MODES = ('device-sparse int8', 'device-sparse int8+fold')


@pytest.fixture(scope="module")
def quality(tmp_path_factory):
    return serve_modes(tmp_path_factory, MODES)


@pytest.mark.parametrize("mode", MODES)
def test_port_meets_the_anchor_bar(quality, mode):
    check_anchor_bar(quality, mode)
