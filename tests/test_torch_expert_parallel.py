"""The port's expert parallelism against JAX's (data, expert) mesh and its
own one process, on the CPU.

  * The sharding rule (`train/mesh.py::held_experts`) shards exactly the
    group stacks that JAX's `moe_param_shardings` shards, block e of each
    on expert rank e, for the flagship's experts at ep = 2, 3, 4 and 6 (at
    4 nothing divides) and for the probe's 4-expert group at ep = 2.
  * The host helpers key on the data rank (the mesh's layout is pinned by
    `tests/test_torch_distributed.py::test_make_mesh`).
  * A tiny mixture of experts in the probe's configuration
    (`tests/_moe_multidevice_probe.py`: 4 one-scale experts on radii 0.1
    and 0.3, 3^3 Gaussians; the tiny backbone) takes 1 and 3 SGD-momentum
    steps on gloo CPU ranks in two layouts, 2 x 2 and 1 x 2:
      - against JAX's step, run in a fresh process by
        `tests/_ep_jax_probe.py` from the same haiku initialization, at
        JAX's bars: loss 1e-4, parameters 5e-4
        (`tests/test_train_e2e.py:197-201`).  The reference is JAX's
        one-device step, because JAX's `make_mesh(2, 2)` step is not that
        step on XLA:CPU's virtual mesh, and placement must not change what
        a jitted function computes: with the expert stacks sharded
        (`place_train_state(..., moe=True)`) its first loss is 1.4352
        against 1.5692 (a bare `jax.vmap` of one tiny expert's eval forward
        with its stacked weights sharded is off by up to 3.5); with them
        replicated the loss agrees but the experts' first Inception convs
        take exactly twice their update, as if their weight gradient were
        summed over both mesh axes (meshes of 2 x 1 and 1 x 2 are
        right).  `test_jax_2x2_mesh_departs_from_jax_one_device` pins both
        faults of the reference;
      - against the port's one process: loss rtol 1e-6, parameters and
        BatchNorm state atol 1e-6 + rtol 1e-5, momentum atol 1e-5 + rtol
        1e-4 (the bars of `tests/test_torch_dp_train.py`);
      - each rank holds its shard only (parameters, optimizer state, state
        dict keys), and its BatchNorm state and replicated parameters equal
        its expert group's and its data group's;
      - a control: a gather whose backward sums over the expert group
        misses the one-process bar;
      - with weight decay the logged loss counts every shard's penalty once.
  * `cli.train --expert_parallel 2 --device cpu` trains 2 epochs and resumes
    to 3; its checkpoint has the one-process layout (keys and shapes of the
    weights, the BatchNorm state and the optimizer state); resuming across
    layouts (ep 2 -> 1 and 1 -> 2) continues at the one-process bars; the
    validation RMS follows the one-process run within 1e-3 degrees; and
    `cli.test` serves the checkpoint.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from nestinet_tpu.core.config import Config as JaxConfig
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.ops.gmm import get_3d_grid_gmm
from nestinet_tpu.train.mesh import make_mesh as jax_make_mesh
from nestinet_tpu.train.mesh import moe_param_shardings
from nestinet_tpu_torch import convert
from nestinet_tpu_torch.core import checkpoint
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.models.experts import expert_groups
from nestinet_tpu_torch.train import distributed, mesh

from . import _ep_jax_probe as probe
from . import test_torch_ep_workers as workers
from .test_torch_dp_train import _argv, _eval_rms
from .test_torch_experts import random_bn
from .test_torch_flax_reader import write_jax_run
from .test_torch_trainer import data  # noqa: F401  (the `data` fixture)
from tests._torch_disk import (  # noqa: F401
    LIMIT_BYTES,
    bytes_left,
    remove_module_tmp,
    remove_tmp_path,
)

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3
N_POINT = 12
BATCH = 8
TIMEOUT = 300  # seconds a launch may take before its ranks are killed
JAX_LOSS_ATOL = 1e-4
JAX_PARAM_ATOL = 5e-4
RMS_ATOL_DEG = 1e-3
PROBE = dict(model="experts_n_est", tiny_backbone=True, patch_radius=(0.1, 0.3),
             num_point=N_POINT, num_gaussians=3, gmm_variance=0.111, batch_size=BATCH,
             n_experts=4, expert_dict={i: [i % 2] for i in range(4)}, optimizer="momentum",
             learning_rate=LR)
LAYOUTS = {"2x2": (2, 2), "1x2": (1, 2)}


# ---------------------------------------------------------------- the rule


def jax_blocks(group_sizes, ep: int) -> list:
    """For each group: None when JAX replicates it, else the leading-axis
    block [start, stop) that the device at (data 0, expert e) holds, for
    each e."""
    params = {"manager": {"fc1/linear": {"w": np.zeros((2, 2))}}}
    params.update({f"group{gi}": {"fc1/linear": {"w": np.zeros((g, 2))}}
                   for gi, g in enumerate(group_sizes)})
    jmesh = jax_make_mesh(1, ep, devices=jax.devices()[:ep])
    out = []
    for gi, g in enumerate(group_sizes):
        sharding = moe_param_shardings(params, jmesh)[f"group{gi}"]["fc1/linear"]["w"]
        if sharding.is_fully_replicated:
            out.append(None)
            continue
        where = sharding.devices_indices_map((g, 2))
        out.append([(where[d][0].start, where[d][0].stop) for d in jmesh.devices[0]])
    return out


@pytest.mark.parametrize("config,ep", [("flagship", 2), ("flagship", 3), ("flagship", 4),
                                       ("flagship", 6), ("probe", 2)])
def test_sharding_rule_is_jax_moe_param_shardings(config, ep):
    cfg = Config() if config == "flagship" else Config(**PROBE)
    groups = [g.indices for g in expert_groups(cfg)]
    want = jax_blocks([len(g) for g in groups], ep)
    assert mesh.sharded_groups([len(g) for g in groups], ep) == [w is not None for w in want]
    for e in range(ep):
        held = mesh.held_experts(groups, e, ep)
        expect = []
        for ids, blocks in zip(groups, want):
            expect += ids if blocks is None else ids[blocks[e][0]:blocks[e][1]]
        assert held == sorted(expect)
    if config == "flagship":
        # 6 one-scale experts and the three-scale singleton: only ep | 6 shards
        assert (want[0] is not None) == (ep in (2, 3, 6)) and want[1] is None


def test_host_helpers_key_on_the_data_rank():
    """World rank 5 of 3 x 2 is data rank 2: the ranks of one expert group
    take the same rows and items."""
    with mock.patch.object(distributed, "process_info", return_value=(5, 6)):
        assert distributed.data_rank_info(2) == (2, 3)
        assert distributed.host_batch_slice(12, 2) == slice(8, 12)
        assert distributed.host_shard(list(range(7)), 2) == [2, 5]
    with mock.patch.object(distributed, "process_info", return_value=(4, 6)):
        assert distributed.host_batch_slice(12, 2) == slice(8, 12)


# ---------------------------------------------------------------- the step


def make_batch(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    points = rng.uniform(-1, 1, size=(BATCH, 2 * N_POINT, 3)).astype(np.float32)
    n_eff = rng.randint(1, N_POINT + 1, size=(BATCH, 2)).astype(np.int32)
    for b in range(BATCH):
        for s in range(2):
            points[b, s * N_POINT + n_eff[b, s]:(s + 1) * N_POINT] = 0.0
    normals = rng.normal(size=(BATCH, 3)).astype(np.float32)
    return {"points": points, "n_eff": n_eff, "normals": normals}


def start_jax_probe(tmp, jcfg_kw, params, state, batch) -> tuple:
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    kw = dict(jcfg_kw, expert_dict={str(k): v for k, v in jcfg_kw["expert_dict"].items()})
    np.savez(src, cfg=json.dumps(kw), steps=STEPS, **probe.flatten(params, "params"),
             **probe.flatten(state, "state"), **{f"batch/{k}": v for k, v in batch.items()})
    proc = subprocess.Popen([sys.executable, probe.__file__, src, dst], env=proc_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, dst


def proc_env() -> dict:
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    return env


def read_jax_probe(proc, dst) -> dict:
    """{placement: [per step: (loss, params, state)]}.  A probe that
    XLA:CPU's rendezvous aborted (SIGABRT, see
    `tests/test_train_e2e.py::test_moe_train_step_multidevice`) runs once
    more."""
    out, err = proc.communicate(timeout=TIMEOUT)
    if proc.returncode == -6:
        proc = subprocess.run(proc.args, env=proc_env(), capture_output=True, text=True,
                              timeout=TIMEOUT)
        out, err = proc.stdout, proc.stderr
    assert proc.returncode == 0, f"JAX probe failed:\n{out[-2000:]}\n{err[-2000:]}"
    flat = dict(np.load(dst))
    return {placement: [(float(flat[f"{placement}/{i}/loss"]),
                         probe.unflatten(flat, f"{placement}/{i}/params"),
                         probe.unflatten(flat, f"{placement}/{i}/state"))
                        for i in range(STEPS)]
            for placement in ("one_device", "sharded", "replicated")}


def merged(ranks: list, step: int) -> dict:
    """The whole model's state dict and moments from every rank's shard."""
    state, moments = {}, {}
    for r in ranks:
        state.update(r["steps"][step]["state_dict"])
        moments.update(r["steps"][step]["moments"])
    return {"loss": ranks[0]["steps"][step]["loss"], "state_dict": state, "moments": moments}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX probe (started first, read last), the port's one
    process (plain, and with weight decay) and the port's 2 x 2 and 1 x 2
    launches (the 1 x 2 one with the summed-backward control and the weight
    decay case)."""
    cfg, jkw = Config(**PROBE), dict(PROBE)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    batch = make_batch(21)
    params, state = jax.jit(jax_build_model(JaxConfig(**jkw), gmm).init)(
        jax.random.PRNGKey(3), batch)
    params, state = random_bn(params, state, np.random.RandomState(13))
    proc, dst = start_jax_probe(str(tmp_path_factory.mktemp("ep_probe")), jkw, params, state,
                                batch)
    case = dict(cfg=cfg, gmm=(gmm.weights, gmm.means, gmm.covariances),
                state_dict=convert.from_haiku(params, state, cfg), batch=batch, steps=STEPS)
    wd = dict(case, cfg=dataclasses.replace(cfg, weight_decay=1e-4), steps=1)
    one = {"plain": workers.ep_case(case)[0], "wd": workers.ep_case(wd)[0]}

    def layout(c, dp, ep, **kw):
        return dict(c, cfg=dataclasses.replace(c["cfg"], data_parallel=dp, expert_parallel=ep),
                    **kw)

    ep = {"2x2": distributed.launch(workers.ep_cases, 2, ([layout(case, 2, 2)],),
                                    expert_parallel=2, device="cpu", timeout=TIMEOUT)[0]}
    ep["1x2"], control, ep_wd = distributed.launch(
        workers.ep_cases, 1, ([layout(case, 1, 2), layout(case, 1, 2, summed=True, steps=1),
                               layout(wd, 1, 2)],),
        expert_parallel=2, device="cpu", timeout=TIMEOUT)
    return {"cfg": cfg, "jax": read_jax_probe(proc, dst), "one": one, "ep": ep,
            "control": control, "ep_wd": ep_wd, "start": case["state_dict"]}


def param_names(cfg) -> list:
    from nestinet_tpu_torch.models import build_model

    return [n for n, _ in build_model(cfg, get_3d_grid_gmm([3, 3, 3], 0.111)).named_parameters()]


def jax_gaps(cfg, got: dict, want) -> tuple[float, float]:
    """(loss gap, largest parameter gap) of a step against JAX's."""
    w_loss, w_params, w_state = want
    ref = convert.from_haiku(w_params, w_state, cfg)
    gap = max((got["state_dict"][k] - ref[k]).abs().max().item() for k in param_names(cfg))
    return abs(got["loss"] - w_loss), gap


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_expert_parallel_step_matches_jax_one_device(runs, name, steps):
    loss_gap, gap = jax_gaps(runs["cfg"], merged(runs["ep"][name], steps - 1),
                             runs["jax"]["one_device"][steps - 1])
    print(f"{name}, {steps} steps: loss gap {loss_gap:.3e}, parameter gap {gap:.3e}")
    assert loss_gap <= JAX_LOSS_ATOL
    assert gap <= JAX_PARAM_ATOL


def test_jax_2x2_mesh_departs_from_jax_one_device(runs):
    """The reference's faults on XLA:CPU's virtual mesh: JAX's 2 x 2 step
    misses JAX's own bars against its one-device step, with the expert
    stacks sharded from the first loss on, with them replicated in the
    first update of the experts' first Inception convs (twice the
    one-device update)."""
    cfg = runs["cfg"]
    one = merged([runs["one"]["plain"]], 0)  # the port's one process: JAX's one device
    sharded = jax_gaps(cfg, one, runs["jax"]["sharded"][0])
    replicated = jax_gaps(cfg, one, runs["jax"]["replicated"][0])
    print(f"JAX 2 x 2 against one device, (loss, parameter) gaps: sharded {sharded}, "
          f"replicated {replicated}")
    assert sharded[0] > JAX_LOSS_ATOL
    assert replicated[0] <= JAX_LOSS_ATOL < replicated[1]
    _, w_params, _ = runs["jax"]["replicated"][0]
    _, o_params, _ = runs["jax"]["one_device"][0]
    for path in ("incep0/conv1/conv", "incep0/conv4/conv", "fc1/linear"):
        start = convert.to_haiku(runs["start"], cfg)[0]["group0"][path]["w"]
        ratio = (np.abs(w_params["group0"][path]["w"] - start).sum()
                 / np.abs(o_params["group0"][path]["w"] - start).sum())
        np.testing.assert_allclose(ratio, 2.0 if path.startswith("incep0") else 1.0, rtol=1e-3)


def assert_one_process_bars(got: dict, want: dict):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert set(got["state_dict"]) == set(want["state_dict"])
    for key, value in want["state_dict"].items():
        torch.testing.assert_close(got["state_dict"][key], value, atol=1e-6, rtol=1e-5,
                                   msg=key)
    assert set(got["moments"]) == set(want["moments"])
    for name, value in want["moments"].items():
        torch.testing.assert_close(got["moments"][name]["momentum_buffer"],
                                   value["momentum_buffer"], atol=1e-5, rtol=1e-4, msg=name)


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_expert_parallel_step_matches_one_process(runs, name, steps):
    assert_one_process_bars(merged(runs["ep"][name], steps - 1),
                            merged([runs["one"]["plain"]], steps - 1))


def test_weight_decay_counts_every_shard_once(runs):
    assert_one_process_bars(merged(runs["ep_wd"], 0), merged([runs["one"]["wd"]], 0))
    assert len({r["steps"][0]["loss"] for r in runs["ep_wd"]}) == 1


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_each_rank_holds_its_shard(runs, name):
    dp, ep = LAYOUTS[name]
    groups = [g.indices for g in expert_groups(runs["cfg"])]
    whole = runs["one"]["plain"]
    sizes = {}
    for key, value in whole["steps"][0]["state_dict"].items():
        owner = int(key.split(".")[1]) if key.startswith("experts.") else None
        sizes.setdefault(owner, {})[key] = value
    for world, r in enumerate(runs["ep"][name]):
        d, e = r["coords"]
        assert (d, e) == divmod(world, ep)
        held = mesh.held_experts(groups, e, ep)
        assert held == ([0, 1] if e == 0 else [2, 3])
        want_keys = set(sizes[None]).union(*(sizes[i] for i in held))
        assert set(r["steps"][0]["state_dict"]) == want_keys
        n = sum(v.numel() for k, v in whole["steps"][0]["state_dict"].items()
                if k in want_keys and k in whole["steps"][0]["moments"])
        assert r["n_params"] == r["n_moments"] == n < whole["n_params"]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_state_is_equal_across_each_expert_group(runs, name):
    """Replicated parameters and the BatchNorm state of the manager, and
    every shard's BatchNorm state, are equal on every rank that holds them:
    across an expert group and across a data group."""
    ranks = runs["ep"][name]
    for step in range(STEPS):
        seen = {}
        for r in ranks:
            for key, value in r["steps"][step]["state_dict"].items():
                if key in seen:
                    assert torch.equal(seen[key], value), (name, step, key)
                seen.setdefault(key, value)
    assert any(k.endswith("ema_var") and k.startswith("manager.") for k in seen)


def test_summed_backward_misses_the_one_process_bar(runs):
    """The control: summing the gather's backward over the expert group
    doubles every sharded expert's gradient."""
    got, want = merged(runs["control"], 0), merged([runs["one"]["plain"]], 0)
    gap = max((got["state_dict"][k] - want["state_dict"][k]).abs().max().item()
              for k in got["state_dict"] if k.startswith("experts."))
    print(f"summed backward: largest expert weight gap {gap:.3e}")
    with pytest.raises(AssertionError):
        assert_one_process_bars(got, want)
    assert gap > 1e-5


def test_jax_run_dir_resumes_under_expert_parallelism(tmp_path):
    """A run dir that JAX's trainer wrote (2 adam steps) resumes on a 1 x 2
    mesh: the next step equals the one-process resume's (which
    `tests/test_torch_flax_reader.py` holds to JAX's next step)."""
    cfg, _, _, path, batch, _ = write_jax_run(str(tmp_path), "experts_n_est")
    for copy in ("one", "ep"):
        shutil.copytree(path, str(tmp_path / copy))
    one = workers.resume_step(cfg, str(tmp_path / "one"), batch)
    ep = distributed.launch(workers.resume_step, 1,
                            (dataclasses.replace(cfg, expert_parallel=2), str(tmp_path / "ep"),
                             batch), expert_parallel=2, device="cpu", timeout=TIMEOUT)
    assert ep[1:3] == one[1:3] == (2, 1)
    np.testing.assert_allclose(ep[0], one[0], rtol=1e-6)
    assert list(ep[3]) == list(one[3])  # the one-process layout, key for key
    for key, value in one[3].items():
        torch.testing.assert_close(ep[3][key], value, atol=1e-6, rtol=1e-5, msg=key)
    assert ep[4]["param_groups"] == one[4]["param_groups"]
    for i, state in one[4]["state"].items():
        assert ep[4]["state"][i]["step"] == state["step"] == 3
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(ep[4]["state"][i][k], state[k], atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------- cli.train


def _checkpoint_layout(run) -> dict:
    payload = checkpoint.load(run, torch.device("cpu"))
    opt = payload["optimizer"]
    return {"state_dict": {k: tuple(v.shape) for k, v in payload["state_dict"].items()},
            "state": {i: {k: tuple(v.shape) for k, v in s.items()}
                      for i, s in opt["state"].items()},
            "params": opt["param_groups"][0]["params"], "step": payload["step"],
            "epoch": payload["epoch"]}


def test_cli_train_expert_parallel_resumes_across_layouts(data, tmp_path):  # noqa: F811
    from nestinet_tpu_torch.cli.test import main as test_main
    from nestinet_tpu_torch.cli.train import main as train_main

    runs = {name: str(tmp_path / name) for name in ("one", "ep", "ep_to_one", "one_to_ep")}
    ep = ("--expert_parallel", "2")
    train_main(_argv(data, runs["one"], 2))
    shutil.copytree(runs["one"], runs["one_to_ep"])
    train_main(_argv(data, runs["ep"], 2, *ep), timeout=TIMEOUT)
    shutil.copytree(runs["ep"], runs["ep_to_one"])
    assert _checkpoint_layout(runs["ep"]) == _checkpoint_layout(runs["one"])
    train_main(_argv(data, runs["one"], 3))
    train_main(_argv(data, runs["ep"], 3, *ep), timeout=TIMEOUT)
    train_main(_argv(data, runs["ep_to_one"], 3))
    train_main(_argv(data, runs["one_to_ep"], 3, *ep), timeout=TIMEOUT)

    want = checkpoint.load(runs["one"], torch.device("cpu"))
    for name in ("ep", "ep_to_one", "one_to_ep"):
        run = runs[name]
        assert not os.path.exists(os.path.join(run, "1"))  # one run dir, resumed in place
        with open(os.path.join(run, "log_train.txt")) as f:
            log = f.read()
        assert "resumed from epoch 1" in log and log.count("train mean loss") == 3
        assert _checkpoint_layout(run) == _checkpoint_layout(runs["one"])
        got = checkpoint.load(run, torch.device("cpu"))
        for key, value in want["state_dict"].items():
            torch.testing.assert_close(got["state_dict"][key], value, atol=1e-6, rtol=1e-5,
                                       msg=f"{name} {key}")
        for i, state in want["optimizer"]["state"].items():
            torch.testing.assert_close(got["optimizer"]["state"][i]["momentum_buffer"],
                                       state["momentum_buffer"], atol=1e-5, rtol=1e-4)
        rms = _eval_rms(run)
        print(f"validation RMS, one process {_eval_rms(runs['one'])}, {name} {rms}")
        np.testing.assert_allclose(rms, _eval_rms(runs["one"]), atol=RMS_ATOL_DEG, rtol=0)

    served = {}
    for name in ("one", "ep"):
        stats = test_main(["--results_path", runs[name], "--dataset_path", data, "--testset",
                           "testset.txt", "--compute_dtype", "float32", "--batch_size", "16",
                           "--device", "cpu"])
        served[name] = {s: np.loadtxt(os.path.join(stats["output_dir"], s + ".normals"))
                        for s in stats["shapes"]}
    assert sorted(served["ep"]) == ["plane", "sphere"]
    for shape, normals in served["ep"].items():
        assert np.isfinite(normals).all()
        np.testing.assert_allclose(normals, served["one"][shape], atol=1e-4)


@pytest.mark.parametrize("test", [
    "test_cli_train_expert_parallel_resumes_across_layouts",
    "test_jax_run_dir_resumes_under_expert_parallelism",
])
def test_leaves_little_in_tmp_path(request, test):
    """Runs after the file's other tests (keep it last): the checkpoints
    `test` wrote are gone from its `tmp_path` once it passed
    (`tests/_torch_disk.py`); before they were removed this file's CLI
    tests left hundreds of MB each in pytest's basetemp."""
    left = bytes_left(request, test)
    assert left < LIMIT_BYTES, f"{test} left {left} bytes in its tmp_path"
