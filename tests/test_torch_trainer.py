"""The port's trainer, its data and its checkpoints.

  * the training loader (the 'random' and 'random_shape_consecutive'
    orders, normal targets, point-count jitter, epochs with and without
    `identical_epochs`, `drop_last`) yields the JAX loader's batches to the
    bit for the same seed;
  * the rotation augmentation draws the JAX package's rotations;
  * a tiny run resumed after an epoch ends equal to an unbroken run, to
    the bit (CPU, one thread: the same operations in the same order);
  * serving prefers the best checkpoint when a run dir holds both slots;
  * `cli.train --resume 1` continues a run in place, as
    `tests/test_train_e2e.py::test_cli_train_resumes_in_place` holds the
    JAX CLI to.
"""

import json
import os

import numpy as np
import pytest
import torch

from nestinet_tpu.data.augment import rotate_patches_and_normals as jax_rotate
from nestinet_tpu.data.loader import get_data_loader as jax_loader
from nestinet_tpu_torch.core import checkpoint
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.core.rundir import RunDir
from nestinet_tpu_torch.data.augment import rotate_patches_and_normals
from nestinet_tpu_torch.data.loader import get_data_loader
from nestinet_tpu_torch.infer.predict import load_run
from nestinet_tpu_torch.models import build_model
from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
from nestinet_tpu_torch.train.trainer import Trainer

from .fixtures import make_plane, make_sphere, write_pcpnet_dataset
from .test_torch_native_race import load_jax_native

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    rng = np.random.RandomState(4)
    shapes = {"plane": make_plane(160, rng, noise=0.01),
              "sphere": make_sphere(140, rng, noise=0.01)}
    write_pcpnet_dataset(root, shapes, list_name="trainingset.txt", n_pidx=30,
                         noise_levels=[0.0, 0.01], seed=4)
    with open(os.path.join(root, "testset.txt"), "w") as f:
        f.write("plane\nsphere\n")
    return root


LOADER_CASES = {
    "random": dict(patch_sample_order="random"),
    "random_no_drop": dict(patch_sample_order="random", drop_last=False),
    "random_identical": dict(patch_sample_order="random", identical_epochs=True),
    "jitter": dict(patch_sample_order="random", patch_point_count_std=0.3),
    "jitter_identical": dict(patch_sample_order="random", patch_point_count_std=0.3,
                             identical_epochs=True),
    "shape_consecutive": dict(patch_sample_order="random_shape_consecutive"),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
@pytest.mark.parametrize("use_native", [True, False])
def test_training_loader_yields_the_jax_loaders_batches(data, case, use_native):
    load_jax_native()
    kwargs = dict(indir=data, batch_size=12, patch_radius=(0.1, 0.2), points_per_patch=20,
                  seed=21, outputs=("unoriented_normals", "noise"), patches_per_shape=25,
                  workers=2, drop_last=True, use_native=use_native)
    kwargs.update(LOADER_CASES[case])
    ours, ds = get_data_loader("trainingset.txt", **kwargs)
    theirs, jds = jax_loader("trainingset.txt", **kwargs)
    assert ds.use_native == jds.use_native
    epochs = []
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours) == len(theirs)
        for x, y in zip(a, b):
            assert x.keys() == y.keys() == {"points", "n_eff", "trans", "normals", "noise"}
            for key in x:
                np.testing.assert_array_equal(x[key], np.asarray(y[key]), err_msg=key)
        epochs.append(a)
    n = sum(len(x["points"]) for x in epochs[0])
    assert n == (48 if kwargs["drop_last"] else 50)
    same = all(np.array_equal(x["points"], y["points"]) for x, y in zip(*epochs))
    assert same == bool(kwargs.get("identical_epochs", False))


def test_unported_outputs_raise(data):
    with pytest.raises(ValueError):
        get_data_loader("trainingset.txt", indir=data, outputs=("max_curvature",))


def test_rotation_augmentation_draws_the_jax_rotations():
    rng = np.random.RandomState(3)
    points = rng.normal(size=(5, 30, 3)).astype(np.float32)
    normals = rng.normal(size=(5, 3)).astype(np.float32)
    for epoch in range(3):
        ours = rotate_patches_and_normals(points, normals, np.random.RandomState(7 + epoch))
        theirs = jax_rotate(points, normals, np.random.RandomState(7 + epoch))
        for a, b in zip(ours, theirs):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    # a rotation: lengths kept
    p, _ = ours
    np.testing.assert_allclose(np.linalg.norm(p, axis=-1), np.linalg.norm(points, axis=-1),
                               rtol=1e-5)


def tiny_cfg(data, log_dir, **kw):
    base = dict(model="experts_n_est", tiny_backbone=True, log_dir=log_dir, data_path=data,
                trainset="trainingset.txt", testset="testset.txt", patch_radius=(0.2, 0.3, 0.4),
                num_point=12, patches_per_shape=16, num_gaussians=3, gmm_variance=1.0 / 9,
                n_experts=3, expert_dict={0: [0], 1: [1], 2: [0, 1, 2]}, batch_size=8,
                max_epoch=3, learning_rate=1e-3, checkpoint_every=1, identical_epochs=True,
                insert_rotation_augmentation=True, decay_step=40)
    base.update(kw)
    return Config(**base)


def _metrics(run_path):
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resumed_run_equals_an_unbroken_run(data, tmp_path):
    """3 epochs of 4 steps straight, against 2 epochs and then a resume to
    3 in a new Trainer on the same run dir: the same weights, BatchNorm
    state, optimizer state, step and train losses, to the bit."""
    whole = Trainer(tiny_cfg(data, str(tmp_path / "whole")), loader_workers=2, device="cpu")
    whole.fit()
    part = Trainer(tiny_cfg(data, str(tmp_path / "part")), loader_workers=2, device="cpu")
    part.fit(max_epoch=2)
    path = part.rundir.path
    for artifact in ("config.json", "gmm.json", "description.txt", "log_train.txt",
                     "metrics.jsonl", "ckpt_torch/model.pt", "ckpt_torch_best/model.pt"):
        assert os.path.exists(os.path.join(path, artifact)), artifact
    resumed = Trainer(tiny_cfg(data, str(tmp_path / "part")), run_dir=RunDir.open(path),
                      loader_workers=2, device="cpu")
    resumed.fit()
    assert resumed.start_epoch == 2 and resumed.step == whole.step == 12
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items())
    train = [[m["loss"] for m in _metrics(p) if m["kind"] == "train"]
             for p in (whole.rundir.path, path)]
    assert train[0] == train[1] and len(train[0]) == 3
    with open(os.path.join(path, "log_train.txt")) as f:
        assert "resumed from epoch 1 (step 8)" in f.read()
    assert checkpoint.load(path, torch.device("cpu"))["epoch"] == 2


def test_resume_never_regresses_the_best_checkpoint(data, tmp_path):
    trainer = Trainer(tiny_cfg(data, str(tmp_path / "run"), max_epoch=1), loader_workers=2,
                      device="cpu")
    trainer.fit()
    path = trainer.rundir.path
    best = checkpoint.load(path, torch.device("cpu"), best=True)
    # a history whose best RMS no later epoch can beat
    with open(os.path.join(path, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"kind": "eval", "epoch": -1, "rms_deg": 0.0}) + "\n")
    again = Trainer(tiny_cfg(data, str(tmp_path / "run"), max_epoch=2),
                    run_dir=RunDir.open(path), loader_workers=2, device="cpu")
    again.fit()
    still = checkpoint.load(path, torch.device("cpu"), best=True)
    assert still["epoch"] == best["epoch"] == 0
    assert checkpoint.load(path, torch.device("cpu"))["epoch"] == 1


def test_serving_prefers_the_best_checkpoint(tmp_path):
    """The ckpt_best pin: a run dir that holds both slots is served from
    the best one (JAX `infer/predict.py:164-169`); without it, from the
    periodic one."""
    cfg = tiny_cfg("unused", str(tmp_path / "run"))
    rd = RunDir.create(cfg.log_dir)
    cfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    gmm.save(rd.gmm_path)
    periodic = build_model(cfg, gmm, torch.Generator().manual_seed(1)).state_dict()
    best = build_model(cfg, gmm, torch.Generator().manual_seed(2)).state_dict()
    checkpoint.save(rd.path, periodic, step=5, epoch=1)
    _, _, _, model = load_run(rd.path, torch.device("cpu"))
    assert all(torch.equal(v, periodic[k]) for k, v in model.state_dict().items())
    checkpoint.save(rd.path, best, step=3, epoch=0, periodic=False, best=True)
    _, _, _, model = load_run(rd.path, torch.device("cpu"))
    assert all(torch.equal(v, best[k]) for k, v in model.state_dict().items())
    assert checkpoint.load(rd.path, torch.device("cpu"))["epoch"] == 1  # resume's slot


def test_one_write_fills_both_slots(tmp_path):
    sd = {"w": torch.arange(4.0)}
    paths = checkpoint.save(str(tmp_path), sd, optimizer={"state": {}}, step=2, epoch=1,
                            periodic=True, best=True)
    assert [os.path.relpath(p, tmp_path) for p in paths] == [
        os.path.join("ckpt_torch", "model.pt"), os.path.join("ckpt_torch_best", "model.pt")]
    for best in (False, True):
        got = checkpoint.load(str(tmp_path), torch.device("cpu"), best=best)
        assert got["step"] == 2 and got["epoch"] == 1 and torch.equal(got["state_dict"]["w"],
                                                                      sd["w"])
    # a later periodic write leaves the best slot as it was
    checkpoint.save(str(tmp_path), {"w": torch.zeros(4)}, step=3, epoch=2)
    assert torch.equal(checkpoint.load(str(tmp_path), torch.device("cpu"),
                                       best=True)["state_dict"]["w"], sd["w"])
    assert not any(n.endswith(".tmp") for _, _, ns in os.walk(tmp_path) for n in ns)


def test_trainer_refuses_what_is_not_ported(data, tmp_path):
    """int8 trains nowhere; an expert axis of 2 needs a process group of 2
    ranks (`train/distributed.py::launch` starts them)."""
    for bad, match in ((dict(compute_dtype="int8"), "serving-only"),
                       (dict(expert_parallel=2), "distributed.launch")):
        with pytest.raises(ValueError, match=match):
            Trainer(tiny_cfg(data, str(tmp_path / "r"), **bad), device="cpu")


def test_cli_train_resumes_in_place(data, tmp_path):
    """`cli.train --resume 1` on an existing run dir continues that run;
    RunDir.create would number a fresh sibling on collision."""
    from nestinet_tpu_torch.cli.train import main as train_main

    log_dir = str(tmp_path / "cli_run")
    argv = ["--data_path", data, "--log_dir", log_dir, "--trainset", "trainingset.txt",
            "--testset", "testset.txt", "--patch_radius", "0.2", "0.3", "0.4",
            "--num_point", "12", "--patches_per_shape", "16", "--num_gaussians", "3",
            "--gmm_variance", "0.111", "--batch_size", "8", "--learning_rate", "1e-3",
            "--checkpoint_every", "1", "--identical_epochs", "1", "--loader_workers", "2",
            "--n_experts", "3", "--expert_dict", '{"0": "[0]", "1": "[1]", "2": "[0, 1, 2]"}',
            "--device", "cpu"]
    cfg_path = os.path.join(log_dir, "config.json")
    train_main(argv + ["--max_epoch", "1"])
    assert checkpoint.load(log_dir, torch.device("cpu"))["epoch"] == 0
    train_main(argv + ["--max_epoch", "2"])
    assert not os.path.exists(os.path.join(log_dir, "1"))
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        assert "resumed from epoch 0" in f.read()
    assert checkpoint.load(log_dir, torch.device("cpu"))["epoch"] == 1
    assert Config.load(cfg_path).max_epoch == 2
