"""A small run dir written by the JAX package, committed inside the port.

`nestinet_tpu_torch/testdata/jax_run_moe3/` holds:
  * `run/`: `config.json`, `gmm.json` and `ckpt/` (flax msgpack and its
    meta) of a tiny-backbone mixture of experts (3^3 Gaussians, one radius,
    32 points a patch, two experts) with random weights and BatchNorm state
    from a seed, the optimizer's state as `momentum` initializes it;
  * `data/`: one synthetic sphere of 400 points and its `testset.txt`;
  * `jax_normals/`: the `.normals`, `.experts` and `.experts_probs` that JAX's
    `cli.test` serves from it on the CPU in float32 with device extraction.
The smallest mixture of experts still has its fixed FC head widths (the
manager's 1024 x 256 layer alone is 1 MB of float32), so the checkpoint is
about 6.7 MB, half of it the optimizer's zero traces.

The writer imports JAX, so it lives here and never in the port:

    JAX_PLATFORMS=cpu python -m tests.test_torch_jax_fixture --write

The tests regenerate the fixture and require the committed files to equal
it (bytes; the served numbers within 1e-6, as XLA's CPU code may sum in
another order on another CPU), and serve the committed run dir with the
port's `cli.test` on the CPU within atol 1e-4 of JAX's normals.
`chip_smoke.py` phase 14c serves it the same way on the card.
"""

import argparse
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: E402,F401

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "nestinet_tpu_torch", "testdata", "jax_run_moe3")
SHAPE = "sphere400"
SEED = 11
SERVED = (".normals", ".experts", ".experts_probs")


def write_fixture(out: str) -> None:
    """Write the fixture into `out` (replacing what is there) with JAX."""
    import jax

    from nestinet_tpu.cli import test as jax_cli_test
    from nestinet_tpu.core import checkpoint as jax_ckpt
    from nestinet_tpu.core.config import Config
    from nestinet_tpu.core.rundir import RunDir
    from nestinet_tpu.data.synthetic import sphere
    from nestinet_tpu.models import build_model
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm
    from nestinet_tpu.train.train_step import make_optimizer

    from tests.test_torch_experts import random_bn

    if os.path.exists(out):
        shutil.rmtree(out)
    data, run = os.path.join(out, "data"), os.path.join(out, "run")
    os.makedirs(data)
    rng = np.random.RandomState(SEED)
    pts, _ = sphere(400, rng)
    np.savetxt(os.path.join(data, SHAPE + ".xyz"), pts)
    with open(os.path.join(data, "testset.txt"), "w") as f:
        f.write(SHAPE + "\n")

    cfg = Config(model="experts_n_est", tiny_backbone=True, log_dir="run", data_path="data",
                 num_point=32, num_gaussians=3, gmm_variance=1.0 / 9, patch_radius=(0.1,),
                 n_experts=2, expert_dict={0: [0], 1: [0]}, optimizer="momentum", seed=SEED)
    rd = RunDir(run)
    cfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    gmm.save(rd.gmm_path)
    model = build_model(cfg, gmm)
    sample = {"points": np.zeros((2, 32, 3), np.float32), "n_eff": np.full((2, 1), 32, np.int32)}
    params, state = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(SEED), sample))
    params, state = random_bn(params, state, rng)
    jax_ckpt.save(rd.ckpt_dir, params=params, state=state,
                  opt_state=make_optimizer(cfg).init(params), step=0, epoch=0)
    served = os.path.join(out, "serve")
    shutil.copytree(run, served)
    shutil.copytree(data, os.path.join(out, "serve_data"))
    jax_cli_test.main(["--results_path", served, "--dataset_path",
                       os.path.join(out, "serve_data"), "--dataset_name", "jax",
                       "--compute_dtype", "float32", "--extraction", "device",
                       "--batch_size", "64"])
    os.makedirs(os.path.join(out, "jax_normals"))
    for ext in SERVED:
        shutil.copy(os.path.join(served, "jax_results", SHAPE + ext),
                    os.path.join(out, "jax_normals", SHAPE + ext))
    shutil.rmtree(served)
    shutil.rmtree(os.path.join(out, "serve_data"))


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_committed_fixture_equals_a_fresh_one(tmp_path):
    fresh = str(tmp_path / "fresh")
    write_fixture(fresh)
    want, got = _files(fresh), _files(FIXTURE)
    assert got.keys() == want.keys()
    for name in want:
        if name.startswith("jax_normals"):
            np.testing.assert_allclose(np.loadtxt(os.path.join(FIXTURE, name)),
                                       np.loadtxt(os.path.join(fresh, name)), atol=1e-6,
                                       err_msg=name)
        else:
            assert got[name] == want[name], name
    size = os.path.getsize(os.path.join(FIXTURE, "run", "ckpt", "model.msgpack"))
    assert size < 8e6


def test_port_serves_the_committed_run_dir(tmp_path):
    """The port's `cli.test`, as a user runs it on a JAX run dir, on a copy
    of the fixture: normals within atol 1e-4 of JAX's, the same experts."""
    from nestinet_tpu_torch.cli import test as cli_test

    run, data = str(tmp_path / "run"), str(tmp_path / "data")
    shutil.copytree(os.path.join(FIXTURE, "run"), run)
    shutil.copytree(os.path.join(FIXTURE, "data"), data)
    cli_test.main(["--results_path", run, "--dataset_path", data, "--dataset_name", "port",
                   "--compute_dtype", "float32", "--extraction", "device", "--batch_size", "64",
                   "--device", "cpu", "--model", "experts_n_est"])
    got = np.loadtxt(os.path.join(run, "port_results", SHAPE + ".normals"))
    want = np.loadtxt(os.path.join(FIXTURE, "jax_normals", SHAPE + ".normals"))
    assert got.shape == want.shape == (400, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    experts = np.loadtxt(os.path.join(run, "port_results", SHAPE + ".experts"))
    np.testing.assert_array_equal(
        experts, np.loadtxt(os.path.join(FIXTURE, "jax_normals", SHAPE + ".experts")))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Write the committed JAX run-dir fixture.")
    parser.add_argument("--write", action="store_true", help=f"rewrite {FIXTURE}")
    if not parser.parse_args().write:
        parser.print_help()
        sys.exit(2)
    write_fixture(FIXTURE)
    print(f"wrote {FIXTURE}")
