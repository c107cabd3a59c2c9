"""The ablation models end to end through the CLIs, on the CPU.

For each of the single-scale, multi-scale and noise-switching models
(narrow: both packages' ablation backbones replaced by `TINY`, as in
`tests/test_torch_ablations.py`), on tiny synthetic sets (300 points a
shape; the switching benchmark for the switching model):
  * the port's `cli.train` runs two epochs and its `cli.test` serves the
    run dense (`--moe_inference dense`, JAX's path for these models; the
    switching model served routed is `tests/test_torch_switching_routed.py`'s)
    with device extraction: metrics for both epochs, the switching
    model's noise_loss among them, finite `.normals` of every point, no
    `.experts` files, and a finite RMS; serving the run on both extraction
    paths reports the switching model's patches per branch
    (`branch_rows`), as many as its noise estimates put on each side;
  * the JAX CLI trains a run dir, the JAX `cli.test` serves it in float32
    with host extraction, and the port's `cli.test` serves the same run dir
    through its msgpack reader: `.normals` within atol 1e-4 of JAX's, for
    the switching model apart from the patches whose noise estimate lies
    within 1e-5 of the 0.015 switch (after these two short epochs every
    patch takes the small-scale branch; both branches are held in
    `tests/test_torch_ablations.py`);
  * the port resumes a JAX CLI run dir whose best checkpoint no resumed
    epoch beats, and serving it still reads JAX's best weights.
"""

import json
import os

import numpy as np
import pytest
import torch

from nestinet_tpu.cli import test as jax_cli_test
from nestinet_tpu.cli import train as jax_cli_train
from nestinet_tpu_torch.cli import test as cli_test
from nestinet_tpu_torch.cli import train as cli_train
from nestinet_tpu_torch.core import checkpoint
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.data.synthetic import build_protocol_benchmark, build_switching_benchmark
from nestinet_tpu_torch.eval.evaluate import evaluate_dataset
from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
from nestinet_tpu_torch.infer.predict import predict_shapes
from nestinet_tpu_torch.models.switching import NOISE_SWITCH_THRESHOLD, SwitchingNormEst
from nestinet_tpu_torch.train.trainer import Trainer

from .test_torch_ablations import ABLATIONS, narrow_backbones
from .test_torch_native_race import load_jax_native
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

N_POINTS = 300
LISTS = {  # model -> (training list, validation list, data set)
    "ss_norm_est": ("trainingset_whitenoise.txt", "validationset.txt", "protocol"),
    "ms_norm_est": ("trainingset_whitenoise.txt", "validationset.txt", "protocol"),
    "ms_sw_n_est": ("trainingset_switching.txt", "validationset_switching.txt", "switching"),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Both synthetic sets, each with a two-shape test list `testset_two.txt`
    (for switching one shape below and one above the switch)."""
    load_jax_native()
    root = str(tmp_path_factory.mktemp("ablation_cli"))
    out = {}
    protocol = os.path.join(root, "protocol")
    sets = build_protocol_benchmark(protocol, n_points=N_POINTS, n_pidx=50, seed=4)
    two = sets["testset.txt"][:2]
    switching = os.path.join(root, "switching")
    sw_sets = build_switching_benchmark(switching, n_points=N_POINTS, n_pidx=50, seed=4)
    sw_two = [n for n in sw_sets["testset_switching.txt"] if n.endswith(("_sw000", "_sw030"))][:2]
    for path, names in ((protocol, two), (switching, sw_two)):
        with open(os.path.join(path, "testset_two.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    out["protocol"], out["switching"] = protocol, switching
    return out


def train_argv(model, data_path, log_dir):
    train, val, _ = LISTS[model]
    return ["--model", model, "--data_path", data_path, "--log_dir", log_dir,
            "--trainset", train, "--testset", val,
            "--patch_radius", *map(str, ABLATIONS[model]), "--num_point", "16",
            "--num_gaussians", "3", "--gmm_variance", "0.111", "--batch_size", "32",
            "--patches_per_shape", "8", "--max_epoch", "2", "--learning_rate", "1e-3",
            "--loader_workers", "2", "--seed", "5"]


def serve_argv(run, data_path, name, *extra):
    return ["--results_path", run, "--dataset_path", data_path, "--testset", "testset_two.txt",
            "--dataset_name", name, "--batch_size", "64", "--compute_dtype", "float32",
            "--loader_workers", "2", *extra]


def read_outputs(data_path, out_dir):
    with open(os.path.join(data_path, "testset_two.txt")) as f:
        shapes = [s.strip() for s in f if s.strip()]
    return shapes, {s: np.loadtxt(os.path.join(out_dir, s + ".normals")) for s in shapes}


def record_noise(monkeypatch) -> list:
    """The switching model's noise estimates of every batch it serves from
    now on, padding rows included."""
    noise = []
    forward_grid = SwitchingNormEst.forward_grid

    def recording(self, grid, *a, **kw):
        out = forward_grid(self, grid, *a, **kw)
        noise.append(out["noise_pred"].numpy().copy())
        return out

    monkeypatch.setattr(SwitchingNormEst, "forward_grid", recording)
    return noise


@pytest.mark.parametrize("model", sorted(ABLATIONS))
def test_port_trains_and_serves(data, tmp_path, monkeypatch, model):
    data_path = data[LISTS[model][2]]
    run = str(tmp_path / "run")
    with narrow_backbones():
        cli_train.main(train_argv(model, data_path, run) + ["--device", "cpu"])
        cli_test.main(serve_argv(run, data_path, "port", "--extraction", "device",
                                "--device", "cpu", "--model", model, "--moe_inference", "dense"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    assert [m["kind"] for m in metrics] == ["train", "eval"] * 2
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert ("noise_loss" in metrics[0]) == (model == "ms_sw_n_est")
    assert checkpoint.load(run, torch.device("cpu"))["epoch"] == 1
    out_dir = os.path.join(run, "port_results")
    shapes, normals = read_outputs(data_path, out_dir)
    for s in shapes:
        assert normals[s].shape == (N_POINTS, 3) and np.isfinite(normals[s]).all()
        assert not os.path.exists(os.path.join(out_dir, s + ".experts"))
    rms = evaluate_dataset(data_path, out_dir, "testset_two", log=lambda *_: None)["rms"]
    assert np.isfinite(rms)
    # serving's stats count the switching model's patches per branch
    for predict, extra in ((predict_shapes_device, {}), (predict_shapes, {"loader_workers": 2})):
        noise = record_noise(monkeypatch)
        with narrow_backbones():
            stats = predict(run, dataset_name="stats", testset="testset_two.txt",
                            data_path=data_path, batch_size=64, compute_dtype="float32",
                            moe_inference="dense", device="cpu", **extra)
        assert "expert_rows" not in stats
        if model != "ms_sw_n_est":
            assert "branch_rows" not in stats
            continue
        # the device path pads each shape's last batch, the host loader only the last one
        counts = [N_POINTS] * 2 if predict is predict_shapes_device else [2 * N_POINTS]
        reals = [min(64, c - s) for c in counts for s in range(0, c, 64)]
        assert len(noise) == stats["n_batches"] == len(reals)
        small = sum(int((n[:r] < NOISE_SWITCH_THRESHOLD).sum()) for n, r in zip(noise, reals))
        assert stats["branch_rows"] == {"small_scale": small,
                                        "large_scale": stats["n_patches"] - small}
    with pytest.raises(ValueError, match="holds"):
        cli_test.main(serve_argv(run, data_path, "x", "--device", "cpu",
                                "--model", "experts_n_est"))


@pytest.mark.parametrize("model", sorted(ABLATIONS))
def test_port_serves_the_jax_clis_run_dir(data, tmp_path, monkeypatch, model):
    data_path = data[LISTS[model][2]]
    run = str(tmp_path / "jax_run")
    noise = record_noise(monkeypatch)
    with narrow_backbones():
        jax_cli_train.main(train_argv(model, data_path, run))
        jax_cli_test.main(serve_argv(run, data_path, "jax"))
        assert not checkpoint.has_torch_checkpoint(run)
        cli_test.main(serve_argv(run, data_path, "port", "--device", "cpu",
                                "--moe_inference", "dense"))
    shapes, want = read_outputs(data_path, os.path.join(run, "jax_results"))
    _, got = read_outputs(data_path, os.path.join(run, "port_results"))
    got, want = (np.concatenate([d[s] for s in shapes]) for d in (got, want))
    keep = np.ones(len(got), bool)
    if model == "ms_sw_n_est":
        est = np.concatenate(noise)[:len(got)]
        keep = np.abs(est - NOISE_SWITCH_THRESHOLD) >= 1e-5
        below = est < NOISE_SWITCH_THRESHOLD
        print(f"switch: {below.mean():.3f} of the patches below 0.015, "
              f"{(~keep).sum()} within 1e-5 of it")
        assert keep.mean() > 0.95
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-4, rtol=0)


def test_resumed_jax_run_keeps_serving_jax_best(data, tmp_path, monkeypatch):
    """The port resumes a JAX CLI run dir whose `ckpt_best/` no resumed
    epoch beats (its evaluation is made to report a worse RMS): serving the
    run afterwards still reads JAX's best weights, which the resume wrote
    into `ckpt_torch_best/`, not the port's periodic checkpoint."""
    model = "ss_norm_est"
    data_path = data[LISTS[model][2]]
    run = str(tmp_path / "jax_run")
    eval_one_epoch = Trainer.eval_one_epoch

    def worse(self, *a, **kw):
        loss, rms = eval_one_epoch(self, *a, **kw)
        return loss, rms + 1e3

    monkeypatch.setattr(Trainer, "eval_one_epoch", worse)
    cpu = torch.device("cpu")
    with narrow_backbones():
        jax_cli_train.main(train_argv(model, data_path, run))
        assert checkpoint.jax_exists(run, best=True) and not checkpoint.has_torch_checkpoint(run)
        cfg = Config.load(os.path.join(run, "config.json"))
        jax_best = checkpoint.load_jax(run, cfg, best=True)
        cli_train.main(train_argv(model, data_path, run) + ["--device", "cpu", "--max_epoch", "3"])
    assert checkpoint.load(run, cpu)["epoch"] == 2  # the port's resumed epoch
    served = checkpoint.load_for_serving(run, cpu, cfg)
    assert served["epoch"] == jax_best["epoch"] < 2
    for k, v in jax_best["state_dict"].items():
        torch.testing.assert_close(served["state_dict"][k], v, rtol=0, atol=0)
