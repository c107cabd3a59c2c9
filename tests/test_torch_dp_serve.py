"""The port's data-parallel serving against its one process and JAX's
8-device mesh, on the CPU.

The tiny-backbone run dir of `tests/test_torch_slice.py` (a JAX checkpoint
and the same weights as a torch one) serves the 6-shape synthetic testset
(1,800 patches, batch 64: 29 batches, the last zero-padded) with host and
device extraction, routed and dense, in float32 and int8.  Two gloo ranks
(`data_parallel=2`, one launch for all eight paths) each serve whole
batches, round-robin, and rank 0 writes the files:
  * `.normals`, `.experts` and `.experts_probs` byte-identical to the port's
    one-process files, the expert counts equal, and every rank's patches
    counted in `per_rank`;
  * against JAX's `data_parallel=8` serving of the same run dir: in float32
    at JAX's own bars for its mesh against one device (ids identical,
    normals within 2e-4 after normalization and 0.01 degrees:
    `tests/test_sparse_moe_infer.py:127-147`,
    `tests/test_device_pipeline.py:187-230`), but the probabilities at the
    port's float32 bar against JAX, atol 1e-4 (`tests/test_torch_slice.py`):
    JAX's mesh bar of 1e-5 is missed at 1.12e-5 to 1.15e-5 on every path by
    the port's float32 rounding, which the one process has too (the two
    ranks' files equal its files byte for byte); in int8 at the port's int8
    bars against JAX's jitted serving (`tests/test_torch_serve_bf16.py`,
    INT8_BARS).
"""

import os

import numpy as np
import pytest
import torch

from nestinet_tpu.infer.device_pipeline import predict_shapes_device as jax_predict_device
from nestinet_tpu.infer.predict import predict_shapes as jax_predict_shapes
from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
from nestinet_tpu_torch.infer.predict import predict_shapes
from nestinet_tpu_torch.train import distributed

from . import test_torch_dp_workers as workers
from .test_torch_serve_bf16 import INT8_BARS, check_against_jax
from .test_torch_slice import BATCH, N_POINTS, build_data, build_run
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

TIMEOUT = 300  # seconds the two-rank launch may take before its ranks are killed
JAX_DP = 8
EXTS = (".normals", ".experts", ".experts_probs")
# name: (extraction, predict kwargs)
RUNS = {f"{ex}_{moe}_{dtype}": (ex, dict(testset="testset.txt", batch_size=BATCH,
                                         moe_inference=moe, compute_dtype=dtype))
        for ex in ("host", "device") for moe in ("sparse", "dense")
        for dtype in ("float32", "int8")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(data, {name: (JAX dp 8 stats, port one-process stats, port dp 2 stats)})."""
    root = str(tmp_path_factory.mktemp("torch_dp_serve"))
    data = build_data(root)
    run_path = build_run(root, data)
    runs = {name: (ex, dict(kw, data_path=data, **({"loader_workers": 2} if ex == "host"
                                                    else {})))
            for name, (ex, kw) in RUNS.items()}
    dp = distributed.launch(workers.serve_all, 2, (run_path, os.path.join(root, "dp"), runs),
                            device="cpu", timeout=TIMEOUT)
    out = {}
    for name, (ex, kw) in runs.items():
        jax_fn, port_fn = ((jax_predict_device, predict_shapes_device) if ex == "device"
                           else (jax_predict_shapes, predict_shapes))
        one = port_fn(run_path, output_dir=os.path.join(root, "one", name), device="cpu", **kw)
        theirs = jax_fn(run_path, output_dir=os.path.join(root, "jax", name),
                        data_parallel=JAX_DP, **kw)
        out[name] = (theirs, one, dp[name])
    return data, out


def _load(stats, shape, ext):
    return np.loadtxt(os.path.join(stats["output_dir"], shape + ext))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_ranks_write_the_one_process_files(served, name):
    _, out = served
    _, one, dp = out[name]
    assert dp["data_parallel"] == 2 and one["data_parallel"] == 1
    assert dp["shapes"] == one["shapes"] and len(dp["shapes"]) == 6
    for shape in dp["shapes"]:
        for ext in EXTS:
            with open(os.path.join(one["output_dir"], shape + ext), "rb") as f:
                want = f.read()
            with open(os.path.join(dp["output_dir"], shape + ext), "rb") as f:
                assert f.read() == want, (shape, ext)
    assert dp["expert_rows"] == one["expert_rows"]
    assert dp["n_patches"] == one["n_patches"] == 6 * N_POINTS
    # the host loader pads the stream's last batch, the device path each shape's
    n_batches = 6 * -(-N_POINTS // BATCH) if name.startswith("device") else -(
        -6 * N_POINTS // BATCH)
    assert dp["n_batches"] == one["n_batches"] == n_batches
    ranks = dp["per_rank"]
    assert [r["n_batches"] for r in ranks] == [-(-n_batches // 2), n_batches // 2]
    assert sum(r["n_patches"] for r in ranks) == dp["n_patches"]
    assert all(set(r["launches"]) >= {"tdmfv_n_est", "int8_conv3d"} for r in ranks)


@pytest.mark.parametrize("name", sorted(n for n in RUNS if n.endswith("float32")))
def test_two_ranks_match_jax_mesh_in_float32(served, name):
    _, out = served
    theirs, _, dp = out[name]
    assert dp["n_patches"] == theirs["n_patches"]
    worst_gap = worst_prob = 0.0
    for shape in dp["shapes"]:
        np.testing.assert_array_equal(_load(dp, shape, ".experts"),
                                      _load(theirs, shape, ".experts"))
        got, want = _load(dp, shape, ".normals"), _load(theirs, shape, ".normals")
        got /= np.linalg.norm(got, axis=1, keepdims=True)
        want /= np.linalg.norm(want, axis=1, keepdims=True)
        np.testing.assert_allclose(got, want, atol=2e-4)
        gap = np.degrees(np.arccos(np.clip(np.abs((got * want).sum(1)), -1, 1)))
        worst_gap = max(worst_gap, gap.max())
        prob = np.abs(_load(dp, shape, ".experts_probs") - _load(theirs, shape,
                                                                  ".experts_probs"))
        worst_prob = max(worst_prob, prob.max())
    print(f"{name}: against JAX dp {JAX_DP}, max angle {worst_gap:.2e} deg, max probability "
          f"gap {worst_prob:.2e}")
    assert worst_gap < 0.01
    assert worst_prob <= 1e-4


@pytest.mark.parametrize("name", sorted(n for n in RUNS if n.endswith("int8")))
def test_two_ranks_match_jax_mesh_in_int8(served, name):
    data, out = served
    theirs, _, dp = out[name]
    check_against_jax(data, theirs, dp, "int8", False, INT8_BARS)
