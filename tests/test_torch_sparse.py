"""The port's routed (argmax-only) MoE serving, on the CPU.

`route_sparse` computes the grid once, runs the manager on the padded
batch and each real patch through its argmax expert only.  Held to the
port's own dense path (ids identical, normals atol 1e-5: the same
arithmetic on a sub-batch) and to the JAX package's routed serving,
`predict_shapes(moe_inference="sparse", compute_dtype="float32")`, on
every point and on the `.pidx` subsets (`.experts` identical, `.normals`
and `.experts_probs` atol 1e-4: float32 with other summation orders).
"""

import os

import numpy as np
import pytest
import torch

from nestinet_tpu.infer.predict import predict_shapes as jax_predict_shapes
from nestinet_tpu_torch.infer.predict import load_run, predict_shapes, route_sparse

from .test_torch_slice import BATCH, N_POINTS, build_data, build_run
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_sparse"))
    data = build_data(root)
    return root, data, build_run(root, data)


@pytest.fixture(scope="module")
def served(run):
    root, data, run_path = run
    common = dict(testset="testset.txt", data_path=data, batch_size=BATCH,
                  loader_workers=2)
    out = {}
    for sparse_patches in (False, True):
        tag = "_pidx" if sparse_patches else ""
        out["jax" + tag] = jax_predict_shapes(
            run_path, output_dir=os.path.join(root, "jax" + tag), moe_inference="sparse",
            compute_dtype="float32", sparse_patches=sparse_patches, **common)
        for mode in ("sparse", "dense"):
            out[mode + tag] = predict_shapes(
                run_path, output_dir=os.path.join(root, mode + tag), device="cpu",
                moe_inference=mode, sparse_patches=sparse_patches, **common)
    return out


def _load(stats, shape, ext):
    return np.loadtxt(os.path.join(stats["output_dir"], shape + ext))


def test_port_sparse_matches_port_dense(served):
    sparse, dense = served["sparse"], served["dense"]
    assert sparse["n_patches"] == dense["n_patches"] == 6 * N_POINTS
    assert sparse["moe_inference"] == "sparse" and dense["moe_inference"] == "dense"
    assert sparse["expert_rows"] == dense["expert_rows"]
    assert sum(sparse["expert_rows"]) == sparse["n_patches"]
    for shape in sparse["shapes"]:
        np.testing.assert_array_equal(_load(sparse, shape, ".experts"),
                                      _load(dense, shape, ".experts"), err_msg=shape)
        np.testing.assert_allclose(_load(sparse, shape, ".normals"),
                                   _load(dense, shape, ".normals"), atol=1e-5, err_msg=shape)
        np.testing.assert_array_equal(_load(sparse, shape, ".experts_probs"),
                                      _load(dense, shape, ".experts_probs"), err_msg=shape)


@pytest.mark.parametrize("tag", ["", "_pidx"])
def test_port_sparse_matches_jax_sparse(served, tag):
    jax_stats, port = served["jax" + tag], served["sparse" + tag]
    assert port["n_patches"] == jax_stats["n_patches"]
    assert port["shapes"] == jax_stats["shapes"]
    ids = []
    for shape in jax_stats["shapes"]:
        ids.append(_load(port, shape, ".experts"))
        np.testing.assert_array_equal(ids[-1], _load(jax_stats, shape, ".experts"),
                                      err_msg=shape)
        for ext in (".normals", ".experts_probs"):
            np.testing.assert_allclose(_load(port, shape, ext), _load(jax_stats, shape, ext),
                                       atol=1e-4, err_msg=shape + ext)
    assert len(np.unique(np.concatenate(ids))) >= 3  # routing spreads


def test_sparse_patches_serve_the_pidx_subsets(served, run):
    _, data, _ = run
    port = served["sparse_pidx"]
    assert port["n_patches"] == 6 * 100
    for shape in port["shapes"]:
        pidx = np.loadtxt(os.path.join(data, shape + ".pidx"))
        assert _load(port, shape, ".normals").shape == (pidx.shape[0], 3)


@pytest.fixture(scope="module")
def model_and_grid(run):
    """The run's model and the grid of one padded batch of random patches."""
    _, _, run_path = run
    _, cfg, _, model = load_run(run_path, torch.device("cpu"))
    rng = np.random.RandomState(4)
    B, N = 24, cfg.num_point
    points = rng.uniform(-1, 1, (B, cfg.n_scales * N, 3)).astype(np.float32)
    n_eff = rng.randint(0, N + 1, (B, cfg.n_scales)).astype(np.int32)
    n_eff[-4:] = 0  # padding rows
    points[-4:] = 0.0
    with torch.inference_mode():
        grid = model.mups_grid(torch.from_numpy(points), torch.from_numpy(n_eff))
    return model, grid, B - 4


def _dense(model, grid, real):
    out = model.forward_grid(grid)
    ids, probs = model.predict_experts(out)
    return model.predict_normals(out)[:real], ids[:real], probs[:real]


def _check_against_dense(model, grid, real):
    with torch.inference_mode():
        normals, ids, probs = route_sparse(model, grid, real)
        d_normals, d_ids, d_probs = _dense(model, grid, real)
    assert normals.shape == (real, 3) and ids.shape == (real,)
    assert probs.shape == (real, model.n_experts)
    torch.testing.assert_close(ids, d_ids, rtol=0, atol=0)
    torch.testing.assert_close(probs, d_probs, rtol=0, atol=0)
    torch.testing.assert_close(normals, d_normals, rtol=0, atol=1e-5)
    return np.bincount(ids.numpy(), minlength=model.n_experts)


def test_route_sparse_with_idle_experts(model_and_grid):
    model, grid, real = model_and_grid
    counts = _check_against_dense(model, grid, real)
    assert counts.sum() == real
    assert np.any(counts == 0) and np.count_nonzero(counts) >= 2


def test_route_sparse_with_one_expert_taking_every_row(model_and_grid):
    model, grid, real = model_and_grid
    last = model.manager.head.fc4.linear
    saved = last.b.detach().clone()
    try:
        with torch.no_grad():
            last.b[5] += 1e3  # expert 5 wins every patch
        counts = _check_against_dense(model, grid, real)
    finally:
        with torch.no_grad():
            last.b.copy_(saved)
    assert counts[5] == real


def test_route_sparse_never_runs_padding_rows(model_and_grid):
    """The experts see only the real rows: an expert that records its
    inputs' batch sizes sees `real` rows in all."""
    model, grid, real = model_and_grid
    seen = []
    hooks = [e.register_forward_hook(lambda m, inp, out: seen.append(inp[0].shape[0]))
             for e in model.experts]
    try:
        with torch.inference_mode():
            route_sparse(model, grid, real)
    finally:
        for h in hooks:
            h.remove()
    assert sum(seen) == real and len(seen) <= model.n_experts


def test_unknown_moe_inference_raises(run):
    _, data, run_path = run
    with pytest.raises(ValueError, match="moe_inference"):
        predict_shapes(run_path, data_path=data, device="cpu", moe_inference="topk")


def _copy_with_dtype(run_path, tmp_path, dtype):
    import shutil

    from nestinet_tpu.core.config import Config
    from nestinet_tpu.core.rundir import RunDir

    copy = str(tmp_path / f"{dtype}_run")
    shutil.copytree(run_path, copy)
    rd = RunDir.open(copy)
    cfg = Config.load(rd.config_path)
    cfg.compute_dtype = dtype
    cfg.save(rd.config_path)
    return copy


def test_run_in_another_compute_dtype_is_refused(run, tmp_path):
    """A run configured for a dtype that neither package serves raises."""
    _, data, run_path = run
    copy = _copy_with_dtype(run_path, tmp_path, "float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        predict_shapes(copy, data_path=data, device="cpu")


def test_run_in_bfloat16_is_served_in_bfloat16(run, served, tmp_path):
    """JAX serves a run whose config says bfloat16 in bfloat16
    (`nestinet_tpu/infer/predict.py:133`), and so does the port: the
    same outputs as the float32 run served with compute_dtype="bfloat16";
    `compute_dtype="float32"` overrides the config back to float32."""
    root, data, run_path = run
    copy = _copy_with_dtype(run_path, tmp_path, "bfloat16")
    _, cfg, _, model = load_run(copy, torch.device("cpu"))
    assert cfg.compute_dtype == "bfloat16" and model.compute_dtype == torch.bfloat16
    common = dict(testset="testset.txt", data_path=data, batch_size=BATCH, loader_workers=2,
                  device="cpu", sparse_patches=True)
    by_config = predict_shapes(copy, output_dir=str(tmp_path / "cfg"), **common)
    by_call = predict_shapes(run_path, output_dir=str(tmp_path / "call"),
                             compute_dtype="bfloat16", **common)
    back = predict_shapes(copy, output_dir=str(tmp_path / "f32"), compute_dtype="float32",
                          **common)
    assert by_config["compute_dtype"] == by_call["compute_dtype"] == "bfloat16"
    assert back["compute_dtype"] == "float32"
    f32 = served["sparse_pidx"]
    moved = 0.0
    for shape in by_config["shapes"]:
        for ext in (".normals", ".experts", ".experts_probs"):
            np.testing.assert_array_equal(_load(by_config, shape, ext), _load(by_call, shape, ext))
            np.testing.assert_array_equal(_load(back, shape, ext), _load(f32, shape, ext))
        moved = max(moved, np.abs(_load(by_config, shape, ".experts_probs")
                                  - _load(f32, shape, ".experts_probs")).max())
    assert moved > 1e-4  # bfloat16 really served
