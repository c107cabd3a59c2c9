"""The port's data-parallel training against JAX's mesh and its own one
process, on the CPU.

Two gloo ranks (`train/distributed.py::launch`) each take 4 of an 8-patch
batch and run 1 and 3 train steps of the narrow single-scale model with
dropout and of the tiny mixture of experts (`tests/test_torch_train_step.py`).
JAX's reference is its `make_mesh(2, 1)` step on two virtual CPU devices,
as `tests/test_train_e2e.py::test_dp_matches_single_device` runs it, from
the same haiku initialization; the single-scale model's dropout masks are
JAX's (recorded from its eager step by `tests/test_torch_ablation_train.py::
run_jax`), each rank keeping its rows of the global masks.

Bars:
  * against JAX's mesh: JAX's own, loss within 1e-4 and every parameter
    within atol 5e-4 (`tests/test_train_e2e.py:197-201`), after 1 and after
    3 steps.  The optimizer is SGD with momentum: adam turns the rounding
    noise of a gradient that is exactly 0 (a bias in front of a train-mode
    BatchNorm) into an update of up to +-lr with a sign of its own in each
    run (`tests/test_torch_train_step.py`), which 3 steps at lr 1e-4 would
    carry to 6e-4;
  * against the port's one process (the same step without collectives, the
    moments reduced in another order): loss rtol 1e-6, every parameter and
    BatchNorm buffer atol 1e-6 + rtol 1e-5, the momentum traces atol 1e-5 +
    rtol 1e-4 (measured at most a few ulp of the loss and about 1e-7 on the
    weights after 3 steps);
  * the BatchNorm state identical on both ranks;
  * a control: the same two ranks with each rank's own BatchNorm moments
    must miss JAX's bar.
`cli.train --data_parallel 2 --device cpu` trains 2 epochs and resumes to 3
into one run dir with rank 0's checkpoints, and its validation RMS follows
the one-process CLI run's within 1e-3 degrees (measured 3.2e-4; one
process on 1 and on 3 threads part by 3.5e-5).  The CLI builds the full
experts backbone, whose float32 gradients move by about 5e-3 relative for
one ulp of input (`nestinet_tpu_torch/scripts/train_step_precision.py`),
so both runs take SGD with momentum at lr 1e-4 for 6 steps: with adam at
1e-3 two one-process runs that differ only in summation order part by
degrees within 12 steps.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.train import train_step as jts
from nestinet_tpu.train.mesh import make_mesh as jax_make_mesh
from nestinet_tpu.train.mesh import shard_batch as jax_shard_batch
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.core import checkpoint
from nestinet_tpu_torch.train import distributed
from nestinet_tpu_torch.train.trainer import Trainer

from . import test_torch_dp_workers as workers
from .test_torch_ablation_train import run_jax as run_jax_dropout
from .test_torch_ablations import make_case, narrow_backbones
from .test_torch_experts import random_bn
from .test_torch_train_step import cfgs as moe_cfgs
from .test_torch_train_step import make_batch as moe_batch
from .test_torch_trainer import data, tiny_cfg  # noqa: F401  (the `data` fixture)
from tests._torch_disk import (  # noqa: F401
    LIMIT_BYTES,
    bytes_left,
    remove_module_tmp,
    remove_tmp_path,
)

torch.set_num_threads(1)

LR = 1e-4
STEPS = 3
OPT = dict(optimizer="momentum", learning_rate=LR)
TIMEOUT = 300  # seconds a launch may take before its ranks are killed
JAX_LOSS_ATOL = 1e-4
JAX_PARAM_ATOL = 5e-4
RMS_ATOL_DEG = 1e-3


def jax_mesh_steps(jcfg, gmm, params, state, batch, dropout: bool):
    """JAX's jitted step on a 2-device data mesh: [(loss, params, state)]
    after each of STEPS steps (`test_train_e2e.py::test_dp_matches_single_device`)."""
    jm = jax_build_model(jcfg, gmm)
    tx = jts.make_optimizer(jcfg)
    mesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])
    p0, s0 = jax.tree.map(jnp.copy, params), jax.tree.map(jnp.copy, state)
    p, s, o = jts.place_train_state(mesh, p0, s0, tx.init(p0))
    step_fn = jts.jit_train_step(jts.make_train_step(jm, jcfg, tx))
    sb = jax_shard_batch(batch, mesh)
    base_key = jax.random.PRNGKey(jcfg.seed + 1)
    out = []
    for i in range(STEPS):
        rng = jax.random.fold_in(base_key, i) if dropout else None
        p, s, o, loss = step_fn(p, s, o, rng, sb, jnp.asarray(i, jnp.int32))
        out.append((float(loss), jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)))
    return out


def ss_case():
    """The narrow single-scale model with dropout: (case, JAX mesh steps)."""
    with narrow_backbones(), pytest.MonkeyPatch.context() as mp:
        cfg, jcfg, gmm, params, state, batch = make_case("ss_norm_est", seed=7, **OPT)
        masks = [step[4] for step in run_jax_dropout("ss_norm_est", jcfg, gmm, params, state,
                                                      batch, mp)]
    with narrow_backbones():
        want = jax_mesh_steps(jcfg, gmm, params, state, batch, dropout=True)
    case = dict(cfg=cfg, gmm=(gmm.weights, gmm.means, gmm.covariances),
                state_dict=convert.from_haiku(params, state, cfg), batch=batch, masks=masks,
                steps=STEPS)
    return case, want


def moe_case():
    """The tiny mixture of experts: (case, JAX mesh steps)."""
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm

    cfg, jcfg = moe_cfgs(**OPT)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=jcfg.gmm_variance)
    batch = moe_batch(11)
    params, state = jax.jit(jax_build_model(jcfg, gmm).init)(jax.random.PRNGKey(5), batch)
    params, state = random_bn(params, state, np.random.RandomState(12))
    want = jax_mesh_steps(jcfg, gmm, params, state, batch, dropout=False)
    case = dict(cfg=cfg, gmm=(gmm.weights, gmm.means, gmm.covariances),
                state_dict=convert.from_haiku(params, state, cfg), batch=batch, masks=None,
                steps=STEPS)
    return case, want


def with_ranks(case: dict, ranks: int, **kw) -> dict:
    import dataclasses

    return dict(case, cfg=dataclasses.replace(case["cfg"], data_parallel=ranks), **kw)


@pytest.fixture(scope="module")
def runs():
    """{model: (JAX mesh steps, one process, two ranks, two ranks with local
    BatchNorm moments)}; the two-rank runs in one launch."""
    cases = {"ss_norm_est": ss_case(), "experts_n_est": moe_case()}
    one = {}
    for name, (case, _) in cases.items():
        if name == "ss_norm_est":
            with narrow_backbones():
                one[name] = workers.train_case(case)
        else:
            one[name] = workers.train_case(case)
    dp_cases = []
    for name, (case, _) in cases.items():
        narrow = name == "ss_norm_est"
        dp_cases += [with_ranks(case, 2, narrow=narrow),
                     with_ranks(case, 2, narrow=narrow, local_bn=True, steps=1)]
    dp = distributed.launch(workers.train_cases, 2, (dp_cases,), device="cpu",
                            timeout=TIMEOUT)
    return {name: (cases[name][1], one[name], dp[2 * i], dp[2 * i + 1])
            for i, name in enumerate(cases)}


def jax_gaps(cfg, model_params: dict, got: dict, want) -> tuple[float, float]:
    """(loss gap, largest parameter gap) of a port step against JAX's."""
    w_loss, w_params, w_state = want
    ref = convert.from_haiku(w_params, w_state, cfg)
    gap = max((got["state_dict"][k] - ref[k]).abs().max().item() for k in model_params)
    return abs(got["loss"] - w_loss), gap


def param_names(name: str, case_cfg) -> list:
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    with narrow_backbones():
        model = build_model(case_cfg, get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9))
    return [n for n, _ in model.named_parameters()]


MODELS = ("ss_norm_est", "experts_n_est")


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("model", MODELS)
def test_two_ranks_match_jax_mesh(runs, model, steps):
    want, _, dp, _ = runs[model]
    names = param_names(model, _cfg(model))
    loss_gap, param_gap = jax_gaps(_cfg(model), names, dp["steps"][steps - 1], want[steps - 1])
    print(f"{model}, {steps} steps: loss gap {loss_gap:.3e}, parameter gap {param_gap:.3e}")
    assert loss_gap <= JAX_LOSS_ATOL
    assert param_gap <= JAX_PARAM_ATOL


def _cfg(model):
    if model == "experts_n_est":
        return moe_cfgs(**OPT)[0]
    from .test_torch_ablations import ablation_cfgs

    return ablation_cfgs(model, **OPT)[0]


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("model", MODELS)
def test_two_ranks_match_one_process(runs, model, steps):
    _, one, dp, _ = runs[model]
    a, b = dp["steps"][steps - 1], one["steps"][steps - 1]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
    worst = 0.0
    for key, value in a["state_dict"].items():
        worst = max(worst, (value - b["state_dict"][key]).abs().max().item())
        torch.testing.assert_close(value, b["state_dict"][key], atol=1e-6, rtol=1e-5, msg=key)
    for got, ref in zip(a["moments"], b["moments"]):
        torch.testing.assert_close(got["momentum_buffer"], ref["momentum_buffer"],
                                   atol=1e-5, rtol=1e-4)
    print(f"{model}, {steps} steps: loss {a['loss']!r} against {b['loss']!r}, "
          f"largest state gap {worst:.3e}")


@pytest.mark.parametrize("model", MODELS)
def test_batch_norm_state_equal_on_every_rank(runs, model):
    _, _, dp, _ = runs[model]
    first, second = dp["buffers"]
    assert set(first) == set(second) and any(k.endswith("ema_var") for k in first)
    for key in first:
        assert torch.equal(first[key], second[key]), key


@pytest.mark.parametrize("model", MODELS)
def test_local_batch_norm_moments_miss_the_jax_bar(runs, model):
    """The control: each rank normalizing with its own 4 rows' moments is
    not JAX's sharded step."""
    want, _, _, local = runs[model]
    names = param_names(model, _cfg(model))
    loss_gap, param_gap = jax_gaps(_cfg(model), names, local["steps"][0], want[0])
    print(f"{model}, local moments: loss gap {loss_gap:.3e}, parameter gap {param_gap:.3e}")
    assert loss_gap > JAX_LOSS_ATOL or param_gap > JAX_PARAM_ATOL
    # and the two ranks' BatchNorm states part
    first, second = local["buffers"]
    assert any(not torch.equal(first[k], second[k]) for k in first if k.endswith("ema_mean"))


# ---------------------------------------------------------------- cli.train


def _argv(data, log_dir, max_epoch, *extra):
    return ["--data_path", data, "--log_dir", log_dir, "--trainset", "trainingset.txt",
            "--testset", "testset.txt", "--patch_radius", "0.2", "0.3", "0.4",
            "--num_point", "12", "--patches_per_shape", "8", "--num_gaussians", "3",
            "--gmm_variance", "0.111", "--batch_size", "8", "--learning_rate", "1e-4",
            "--checkpoint_every", "1", "--identical_epochs", "1", "--loader_workers", "2",
            "--n_experts", "3", "--expert_dict", '{"0": "[0]", "1": "[1]", "2": "[0, 1, 2]"}',
            "--optimizer", "momentum", "--device", "cpu", "--max_epoch", str(max_epoch),
            *extra]


def _eval_rms(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [r["rms_deg"] for r in map(json.loads, f) if r["kind"] == "eval"]


def test_cli_train_data_parallel_resumes_like_one_process(data, tmp_path):  # noqa: F811
    from nestinet_tpu_torch.cli.train import main as train_main

    one, dp = str(tmp_path / "one"), str(tmp_path / "dp")
    train_main(_argv(data, one, 2))
    train_main(_argv(data, one, 3))
    train_main(_argv(data, dp, 2, "--data_parallel", "2"), timeout=TIMEOUT)
    train_main(_argv(data, dp, 3, "--data_parallel", "2"), timeout=TIMEOUT)
    assert sorted(os.listdir(tmp_path)) == ["dp", "one"]
    assert not os.path.exists(os.path.join(dp, "1"))  # one run dir, resumed in place
    with open(os.path.join(dp, "log_train.txt")) as f:
        log = f.read()
    assert "resumed from epoch 1" in log and log.count("train mean loss") == 3
    payload = checkpoint.load(dp, torch.device("cpu"))
    assert payload["epoch"] == 2 and payload["step"] == 3 * 2  # 16 patches, 2 steps an epoch
    assert checkpoint.exists(dp, best=True)
    want, got = _eval_rms(one), _eval_rms(dp)
    print(f"validation RMS, one process {want}, two ranks {got}")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=RMS_ATOL_DEG, rtol=0)


def test_trainer_needs_a_group_for_data_parallel(data, tmp_path):  # noqa: F811
    with pytest.raises(ValueError, match="distributed.launch"):
        Trainer(tiny_cfg(data, str(tmp_path / "r"), data_parallel=2), device="cpu")


@pytest.mark.parametrize("test", [
    "test_cli_train_data_parallel_resumes_like_one_process",
])
def test_leaves_little_in_tmp_path(request, test):
    """Runs after the file's other tests (keep it last): the checkpoints
    `test` wrote are gone from its `tmp_path` once it passed
    (`tests/_torch_disk.py`); before they were removed this file's CLI
    tests left hundreds of MB each in pytest's basetemp."""
    left = bytes_left(request, test)
    assert left < LIMIT_BYTES, f"{test} left {left} bytes in its tmp_path"
