"""The port's serving slice end to end against the JAX package, on the CPU.

One tiny-backbone `experts_n_est` run dir holds a JAX checkpoint and the
same weights converted to the port's torch checkpoint.  JAX
`predict_shapes(moe_inference="dense", compute_dtype="float32")` and the
port's `predict_shapes(device="cpu", moe_inference="dense")` serve the
synthetic protocol testset into two output dirs (the last batch is
zero-padded, so rows with
n_eff = 0 go through both).  Bars: `.normals` within atol 1e-4
elementwise (float32, different summation orders), `.experts`
identical, evaluate.py RMS within 0.01 degrees.
"""

import os

import jax
import numpy as np
import pytest
import torch

from nestinet_tpu.core import checkpoint as jax_ckpt
from nestinet_tpu.core.rundir import RunDir
from nestinet_tpu.data.synthetic import TEST_SHAPES, build_protocol_benchmark
from nestinet_tpu.eval.evaluate import evaluate_dataset
from nestinet_tpu.infer.predict import predict_shapes as jax_predict_shapes
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu.train.train_step import make_optimizer
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.core import checkpoint
from nestinet_tpu_torch.infer.predict import predict_shapes

from .test_torch_experts import random_bn, tiny_cfg
from .test_torch_native_race import load_jax_native

torch.set_num_threads(1)

N_POINTS = 300
BATCH = 64


def _spread_manager_logits(params, state, cfg, gmm, data):
    """Rescale the manager's last layer so that its logits on real test
    patches are about 1 + 2 N(0, 1) per expert: with random weights they
    otherwise sit below the final ReLU for most experts, every patch routes
    to one expert, and the argmax comparison would check little."""
    from nestinet_tpu.data.loader import get_data_loader

    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import GridGMM

    loader, _ = get_data_loader(
        "testset.txt", indir=data, batch_size=256, patch_radius=cfg.patch_radius,
        points_per_patch=cfg.num_point, outputs=(), seed=cfg.seed,
        patch_sample_order="full",
    )
    batch = next(iter(loader))
    model = build_model(cfg, GridGMM(gmm.weights, gmm.means, gmm.covariances))
    model.load_state_dict(convert.from_haiku(params, state, cfg))
    model.eval()
    head = model.manager.head
    with torch.inference_mode():
        grid = model.mups_grid(torch.from_numpy(batch["points"]),
                               torch.from_numpy(batch["n_eff"]))
        h = model.manager.backbone(grid.permute(0, 4, 1, 2, 3))
        h = head.fc3(head.fc2(head.fc1(h))).numpy()
    last = params["manager"]["fc4/linear"]
    z = h @ last["w"]
    scale = 2.0 / z.std(axis=0)
    last["w"] = (last["w"] * scale).astype(np.float32)
    last["b"] = (1.0 - z.mean(axis=0) * scale).astype(np.float32)


def build_run(root: str, data: str) -> str:
    """A tiny-backbone `experts_n_est` run dir over `data` holding a JAX
    checkpoint (random weights and BN state from a seed, manager logits
    spread) and the same weights converted to the port's torch checkpoint;
    returns its path."""
    cfg = tiny_cfg(log_dir=os.path.join(root, "run"), data_path=data,
                   num_gaussians=3, gmm_variance=1.0 / 9, num_point=16,
                   patch_radius=(0.05, 0.1, 0.2))
    rd = RunDir.create(cfg.log_dir)
    cfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    gmm.save(rd.gmm_path)

    rng = np.random.RandomState(7)
    jmodel = jax_build_model(cfg, gmm)
    sample = {"points": rng.uniform(-1, 1, (4, 48, 3)).astype(np.float32),
              "n_eff": np.full((4, 3), 16, np.int32)}
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(1), sample)
    params, state = random_bn(params, state, rng)
    _spread_manager_logits(params, state, cfg, gmm, data)
    jax_ckpt.save(rd.ckpt_dir, params=params, state=state,
                  opt_state=make_optimizer(cfg).init(params), step=0, epoch=0)
    checkpoint.save(rd.path, convert.from_haiku(params, state, cfg))
    return rd.path


def build_data(root: str) -> str:
    """The synthetic protocol testset: 6 shapes x 300 points, 100 pidx;
    both packages' native samplers are loaded, so their host loaders agree."""
    load_jax_native()
    data = os.path.join(root, "data")
    build_protocol_benchmark(data, n_points=N_POINTS, n_pidx=100, seed=5)
    return data


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_slice"))
    data = build_data(root)
    run_path = build_run(root, data)

    common = dict(testset="testset.txt", data_path=data, batch_size=BATCH,
                  loader_workers=2, moe_inference="dense")
    jax_stats = jax_predict_shapes(
        run_path, output_dir=os.path.join(root, "jax"), compute_dtype="float32",
        **common,
    )
    port_stats = predict_shapes(
        run_path, output_dir=os.path.join(root, "port"), device="cpu", **common
    )
    return data, jax_stats, port_stats


def test_slice_serves_every_point(served):
    _, jax_stats, port_stats = served
    n = len(TEST_SHAPES) * N_POINTS
    assert n % BATCH != 0  # the last batch is zero-padded
    assert port_stats["n_patches"] == jax_stats["n_patches"] == n
    assert port_stats["shapes"] == jax_stats["shapes"]
    assert port_stats["device"] == "cpu"


def test_slice_outputs_match_jax(served):
    _, jax_stats, port_stats = served
    ids = []
    for shape in jax_stats["shapes"]:
        path = lambda d, ext: os.path.join(d["output_dir"], shape + ext)  # noqa: E731
        want = np.loadtxt(path(jax_stats, ".normals"))
        got = np.loadtxt(path(port_stats, ".normals"))
        assert got.shape == want.shape == (N_POINTS, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=shape)
        ids.append(np.loadtxt(path(port_stats, ".experts")))
        np.testing.assert_array_equal(
            ids[-1], np.loadtxt(path(jax_stats, ".experts")), err_msg=shape
        )
        np.testing.assert_allclose(
            np.loadtxt(path(port_stats, ".experts_probs")),
            np.loadtxt(path(jax_stats, ".experts_probs")), atol=1e-4, err_msg=shape,
        )
    # the manager routes to several experts, so argmax agreement is a real check
    assert len(np.unique(np.concatenate(ids))) >= 3


def test_slice_rms_matches_jax(served):
    data, jax_stats, port_stats = served
    quiet = lambda *_: None  # noqa: E731
    want = evaluate_dataset(data, jax_stats["output_dir"], "testset", log=quiet)
    got = evaluate_dataset(data, port_stats["output_dir"], "testset", log=quiet)
    assert np.isfinite(got["rms"])
    assert abs(got["rms"] - want["rms"]) < 0.01


def test_cli_serves_data_parallel(served):
    """`cli.test --data_parallel 2` serves on two gloo ranks and writes the
    one-process files byte for byte."""
    from nestinet_tpu_torch.cli import test as cli_test

    data, _, port_stats = served
    run_path = os.path.join(os.path.dirname(port_stats["output_dir"]), "run")
    cli_test.main(["--results_path", run_path, "--dataset_path", data, "--testset",
                   "testset.txt", "--batch_size", str(BATCH), "--moe_inference", "dense",
                   "--compute_dtype", "float32", "--loader_workers", "2", "--data_parallel",
                   "2", "--device", "cpu"], timeout=300)
    out_dir = os.path.join(run_path, "pcpnet_results")
    for shape in port_stats["shapes"]:
        for ext in (".normals", ".experts", ".experts_probs"):
            with open(os.path.join(out_dir, shape + ext), "rb") as a, open(
                    os.path.join(port_stats["output_dir"], shape + ext), "rb") as b:
                assert a.read() == b.read(), (shape, ext)


def test_cli_refuses_an_unknown_dtype(capsys):
    from nestinet_tpu_torch.cli import test as cli_test

    with pytest.raises(SystemExit):
        cli_test.main(["--results_path=unused", "--compute_dtype=float16"])
    assert "invalid choice" in capsys.readouterr().err


def _fake_serving(monkeypatch):
    """Replace both serving functions of the CLI by recorders."""
    from nestinet_tpu_torch.cli import test as cli_test

    calls = []

    def fake(name):
        def serve(run_dir, **kw):
            calls.append((name, run_dir, kw))
            return {"n_patches": 0, "shapes": []}
        return serve

    monkeypatch.setattr(cli_test, "predict_shapes_device", fake("device"))
    monkeypatch.setattr(cli_test, "predict_shapes", fake("host"))
    return cli_test, calls


@pytest.mark.parametrize("flags,dtype,fold_bn", [
    ([], "bfloat16", None),  # the JAX CLI's defaults
    (["--compute_dtype=float32"], "float32", None),
    (["--compute_dtype=bfloat16", "--fold_bn=1"], "bfloat16", True),
    (["--compute_dtype=int8"], "int8", None),
    (["--compute_dtype=int8", "--fold_bn=0"], "int8", False),
])
@pytest.mark.parametrize("extraction", ["device", "host"])
def test_cli_serving_dtypes(monkeypatch, extraction, flags, dtype, fold_bn):
    """`--compute_dtype` defaults to bfloat16 as in JAX
    (`nestinet_tpu/cli/test.py:52`); `--fold_bn` defaults to the run
    config's (None); both reach the serving function."""
    cli_test, calls = _fake_serving(monkeypatch)
    cli_test.main(["--results_path=run", f"--extraction={extraction}", *flags])
    ((name, _, kw),) = calls
    assert name == extraction
    assert kw["compute_dtype"] == dtype and kw["fold_bn"] is fold_bn


@pytest.mark.parametrize("extraction", ["device", "host"])
def test_cli_accepts_routed_modes(monkeypatch, capsys, extraction):
    """Routed serving is the CLI's default, with either extraction; each
    goes to its serving function with the flags it was given."""
    cli_test, calls = _fake_serving(monkeypatch)
    cli_test.main(["--results_path=run", f"--extraction={extraction}",
                   "--moe_inference=sparse", "--sparse_patches=1", "--batch_size=256"])
    ((name, run_dir, kw),) = calls
    assert (name, run_dir) == (extraction, "run")
    assert kw["moe_inference"] == "sparse" and kw["sparse_patches"] is True
    assert kw["batch_size"] == 256
    assert '"n_patches": 0' in capsys.readouterr().out
    calls.clear()
    cli_test.main(["--results_path=run", f"--extraction={extraction}"])
    assert calls[0][2]["moe_inference"] == "sparse"  # the JAX CLI's default


def test_default_device_never_falls_back_to_cpu(served):
    """Serving defaults to CUDA; without a GPU it raises instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from nestinet_tpu_torch.core.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    data, _, port_stats = served
    run_path = os.path.join(os.path.dirname(port_stats["output_dir"]), "run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_shapes(run_path, testset="testset.txt", data_path=data)
