"""The port's serving with on-device extraction against the JAX package's,
on the CPU.

`predict_shapes_device(device="cpu")` of the port and JAX's
`predict_shapes_device(compute_dtype="float32")` serve one tiny-backbone
run dir over the synthetic protocol testset, routed and dense, on every
point and on the `.pidx` subsets.  Both draw the same host random
sequence and the same per-batch, per-radius seeds, and select the same
neighbours (tests/test_torch_ball_query.py pins the selection exactly),
so the bars are those of the host path: `.experts` identical, `.normals`
and `.experts_probs` atol 1e-4, RMS within 0.01 degrees.  At these radii
and 16 points per patch most balls are larger than a patch, so the seeded
draw decides the patches.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nestinet_tpu.core.config import Config
from nestinet_tpu.core.rundir import RunDir
from nestinet_tpu.eval.evaluate import evaluate_dataset
from nestinet_tpu.infer.device_pipeline import predict_shapes_device as jax_predict_device
from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device

from .test_torch_slice import N_POINTS, build_data, build_run
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

BATCH = 128
MODES = {"sparse": ("sparse", False), "dense": ("dense", False),
         "sparse_pidx": ("sparse", True)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_device"))
    data = build_data(root)
    return root, data, build_run(root, data)


@pytest.fixture(scope="module")
def served(run):
    root, data, run_path = run
    common = dict(testset="testset.txt", data_path=data, batch_size=BATCH)
    out = {}
    for name, (mode, pidx) in MODES.items():
        kw = dict(common, moe_inference=mode, sparse_patches=pidx)
        out["jax_" + name] = jax_predict_device(
            run_path, output_dir=os.path.join(root, "jax_" + name),
            compute_dtype="float32", **kw)
        out[name] = predict_shapes_device(
            run_path, output_dir=os.path.join(root, name), device="cpu", **kw)
    return out


def _load(stats, shape, ext):
    return np.loadtxt(os.path.join(stats["output_dir"], shape + ext))


@pytest.mark.parametrize("name", sorted(MODES))
def test_device_serving_matches_jax(served, name):
    jax_stats, port = served["jax_" + name], served[name]
    assert port["n_patches"] == jax_stats["n_patches"]
    assert port["shapes"] == jax_stats["shapes"]
    assert port["moe_inference"] == MODES[name][0]
    ids = []
    for shape in port["shapes"]:
        ids.append(_load(port, shape, ".experts"))
        np.testing.assert_array_equal(ids[-1], _load(jax_stats, shape, ".experts"),
                                      err_msg=shape)
        for ext in (".normals", ".experts_probs"):
            np.testing.assert_allclose(_load(port, shape, ext), _load(jax_stats, shape, ext),
                                       atol=1e-4, err_msg=shape + ext)
    assert len(np.unique(np.concatenate(ids))) >= 3  # routing spreads
    assert sum(port["expert_rows"]) == port["n_patches"]


@pytest.mark.parametrize("name", ["sparse", "dense"])
def test_device_serving_rms_matches_jax(served, run, name):
    _, data, _ = run
    quiet = lambda *_: None  # noqa: E731
    want = evaluate_dataset(data, served["jax_" + name]["output_dir"], "testset", log=quiet)
    got = evaluate_dataset(data, served[name]["output_dir"], "testset", log=quiet)
    assert np.isfinite(got["rms"])
    assert abs(got["rms"] - want["rms"]) < 0.01


def test_sparse_patches_count(served):
    assert served["sparse_pidx"]["n_patches"] == 6 * 100
    assert served["sparse"]["n_patches"] == 6 * N_POINTS
    assert N_POINTS % BATCH != 0  # each shape's last batch is zero-padded


def test_balls_exceed_the_patch_so_the_draw_decides(served, run):
    """Most balls of the largest radius hold more than num_point points, so
    the patches are the seeded draw's; a different seed draws other
    patches and other normals, while the JAX seed reproduced JAX's."""
    root, data, run_path = run
    cfg = Config.load(RunDir.open(run_path).config_path)
    cloud = np.loadtxt(os.path.join(data, served["sparse"]["shapes"][0] + ".xyz"))
    radius = cfg.patch_radius[-1] * np.linalg.norm(cloud.max(0) - cloud.min(0))
    sizes = np.array([len(b) for b in cKDTree(cloud).query_ball_point(cloud, radius)])
    assert np.mean(sizes > cfg.num_point) > 0.5
    assert max(served["sparse"]["window_caps"]) > cfg.num_point  # the draw path

    other = predict_shapes_device(
        run_path, output_dir=os.path.join(root, "other_seed"), testset="testset.txt",
        data_path=data, batch_size=BATCH, device="cpu", seed=11,
    )
    shape = served["sparse"]["shapes"][0]
    assert not np.allclose(_load(other, shape, ".normals"),
                           _load(served["sparse"], shape, ".normals"), atol=1e-3)
