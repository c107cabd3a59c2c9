"""The port imports no JAX, jaxlib, haiku, flax, optax or msgpack, and
nothing of the JAX package `nestinet_tpu`, directly or through anything it
imports: the GPU machine it serves on has none of the former, and the
reference must not change the port behind its back.

A subprocess blocks those packages and `nestinet_tpu` in `sys.modules`
before anything else, imports every module of the port, and runs a tiny CPU
forward, dense and routed on device-extracted patches, then the same model
folded and in int8, then one train and one eval step; then a full-depth
single-scale model's forward, and the committed JAX run dir
(`nestinet_tpu_torch/testdata/jax_run_moe3/`) read by the flax-free reader
and served; then the CLIs `synth`, `test_all`, `evaluate
--expert_statistics 1` and `scan` (a 16-bit depth PNG) on that run dir,
and the host library (PLY, voxels, rotations, augmentations), on the CPU.  PIL, matplotlib, tensorboard and sklearn are blocked too:
the GPU machine has none of them.  An AST scan of every file of the port and of `chip_smoke.py`
fails on any import of those packages, `nestinet_tpu` or their submodules,
including the imports inside functions that the subprocess never reaches.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    BLOCKED = ("jax", "jaxlib", "haiku", "flax", "optax", "msgpack", "nestinet_tpu",
               "PIL", "matplotlib", "tensorboard", "sklearn")
    for name in BLOCKED:
        sys.modules[name] = None  # any import of them now raises ImportError

    import importlib
    for mod in (
        "nestinet_tpu_torch",
        "nestinet_tpu_torch.core.device",
        "nestinet_tpu_torch.core.checkpoint",
        "nestinet_tpu_torch.core.flax_msgpack",
        "nestinet_tpu_torch.core.config",
        "nestinet_tpu_torch.core.profiling",
        "nestinet_tpu_torch.core.rundir",
        "nestinet_tpu_torch.core.textio",
        "nestinet_tpu_torch.core.tb",
        "nestinet_tpu_torch.data.depth",
        "nestinet_tpu_torch.eval.expert_stats",
        "nestinet_tpu_torch.infer.scan",
        "nestinet_tpu_torch.cli.scan",
        "nestinet_tpu_torch.cli.test_all",
        "nestinet_tpu_torch.cli.evaluate",
        "nestinet_tpu_torch.cli.synth",
        "nestinet_tpu_torch.data",
        "nestinet_tpu_torch.data.pcpnet",
        "nestinet_tpu_torch.data.dataset",
        "nestinet_tpu_torch.data.loader",
        "nestinet_tpu_torch.data.augment",
        "nestinet_tpu_torch.data.rotations",
        "nestinet_tpu_torch.data.ply",
        "nestinet_tpu_torch.data.pointcloud",
        "nestinet_tpu_torch.data.modelnet",
        "nestinet_tpu_torch.train.distributed",
        "nestinet_tpu_torch.train.mesh",
        "nestinet_tpu_torch.data.native",
        "nestinet_tpu_torch.data.synthetic",
        "nestinet_tpu_torch.eval",
        "nestinet_tpu_torch.eval.evaluate",
        "nestinet_tpu_torch.eval.metrics",
        "nestinet_tpu_torch.ops.gmm",
        "nestinet_tpu_torch.ops.mups",
        "nestinet_tpu_torch.ops.nn",
        "nestinet_tpu_torch.ops.kernels.build",
        "nestinet_tpu_torch.ops.kernels.mups_cuda",
        "nestinet_tpu_torch.ops.kernels.int8_cuda",
        "nestinet_tpu_torch.ops.fold",
        "nestinet_tpu_torch.ops.quant",
        "nestinet_tpu_torch.models",
        "nestinet_tpu_torch.models.backbones",
        "nestinet_tpu_torch.models.base",
        "nestinet_tpu_torch.models.experts",
        "nestinet_tpu_torch.models.ss",
        "nestinet_tpu_torch.models.ms",
        "nestinet_tpu_torch.models.switching",
        "nestinet_tpu_torch.models.losses",
        "nestinet_tpu_torch.train.schedules",
        "nestinet_tpu_torch.train.train_step",
        "nestinet_tpu_torch.train.trainer",
        "nestinet_tpu_torch.cli.train",
        "nestinet_tpu_torch.convert",
        "nestinet_tpu_torch.infer.writer",
        "nestinet_tpu_torch.infer.predict",
        "nestinet_tpu_torch.infer.device_pipeline",
        "nestinet_tpu_torch.ops.ball_query",
        "nestinet_tpu_torch.scripts.mups_kernel_exp",
        "nestinet_tpu_torch.scripts.int8_kernel_parts",
        "nestinet_tpu_torch.scripts.serve_compare",
        "nestinet_tpu_torch.scripts.train_step_precision",
        "nestinet_tpu_torch.cli.test",
    ):
        importlib.import_module(mod)

    import torch
    torch.set_num_threads(1)
    from nestinet_tpu_torch.core.config import Config
    from nestinet_tpu_torch.eval.evaluate import evaluate_dataset
    from nestinet_tpu_torch.data.synthetic import build_protocol_benchmark
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    cfg = Config(tiny_backbone=True, num_point=8, num_gaussians=3)
    model = build_model(cfg, get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9),
                        torch.Generator().manual_seed(0))
    model.eval()
    g = torch.Generator().manual_seed(1)
    points = torch.rand((4, 24, 3), generator=g) * 2 - 1
    n_eff = torch.tensor([[8, 8, 8], [7, 3, 0], [0, 0, 0], [5, 8, 1]], dtype=torch.int32)
    with torch.inference_mode():
        out = model(points, n_eff)
        normals = model.predict_normals(out)
    assert normals.shape == (4, 3) and torch.isfinite(normals).all()
    assert out["experts_prob"].shape == (7, 4)

    from nestinet_tpu_torch.infer.device_pipeline import extract_batch
    from nestinet_tpu_torch.infer.predict import route_sparse
    from nestinet_tpu_torch.ops.ball_query import build_grid

    cloud = torch.rand((200, 3), generator=g)
    radii = (0.2, 0.3, 0.4)
    grids = [build_grid(cloud, r) for r in radii]
    pts, ne = extract_batch(grids, cloud[:4], radii, 7, num_point=8, caps=(64,) * 3)
    with torch.inference_mode():
        normals, ids, probs = route_sparse(model, model.mups_grid(pts, ne), 3)
    assert normals.shape == (3, 3) and torch.isfinite(normals).all()
    assert ids.shape == (3,) and probs.shape == (3, 7)

    import dataclasses
    from nestinet_tpu_torch.ops.fold import fold_bn_
    from nestinet_tpu_torch.ops.quant import quantize_

    q = build_model(dataclasses.replace(cfg, compute_dtype="int8", fold_bn=True),
                    get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9))
    q.load_state_dict(model.state_dict())
    quantize_(fold_bn_(q)).eval()
    with torch.inference_mode():
        grid = q.mups_grid(pts, ne)
        assert grid.dtype == torch.bfloat16
        normals, ids, probs = route_sparse(q, grid, 3)
    assert normals.dtype == probs.dtype == torch.float32
    assert torch.isfinite(normals).all() and torch.isfinite(probs).all()
    import os, tempfile
    import numpy as np
    from nestinet_tpu_torch.core import textio
    with tempfile.TemporaryDirectory() as tmp:
        build_protocol_benchmark(tmp, n_points=60, n_pidx=10, seed=3)
        names = [s.strip() for s in open(os.path.join(tmp, "testset.txt")) if s.strip()]
        for name in names:
            nrm = np.loadtxt(os.path.join(tmp, name + ".normals"))
            textio.savetxt(os.path.join(tmp, name + ".pred.normals"), nrm)
        res = os.path.join(tmp, "res")
        os.makedirs(res)
        for name in names:
            os.replace(os.path.join(tmp, name + ".pred.normals"),
                       os.path.join(res, name + ".normals"))
        summary = evaluate_dataset(tmp, res, "testset", log=lambda *_: None)
    assert summary["rms"] < 1e-3 and summary["pgp5"] == 1.0

    from nestinet_tpu_torch.train.train_step import (
        make_eval_step, make_optimizer, make_train_step)
    batch = {"points": points, "n_eff": n_eff,
             "normals": torch.rand((4, 3), generator=g) - 0.5}
    opt = make_optimizer(model, cfg)
    before = model.manager.head.fc1.linear.w.clone()
    loss = make_train_step(model, cfg, opt)(batch, 0)
    assert torch.isfinite(loss) and not torch.equal(before, model.manager.head.fc1.linear.w)
    eval_loss, cos = make_eval_step(model)(batch)
    assert torch.isfinite(eval_loss) and cos.shape == (4,)

    ss = build_model(Config(model="ss_norm_est", num_point=8, num_gaussians=3,
                            patch_radius=(0.05,)), get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9))
    with torch.inference_mode():
        out = ss.eval()(points[:, :8], n_eff[:, :1])
    assert out["n_pred"].shape == (4, 3)

    import shutil
    from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
    with tempfile.TemporaryDirectory() as tmp:
        fixture = os.path.join("nestinet_tpu_torch", "testdata", "jax_run_moe3")
        shutil.copytree(os.path.join(fixture, "run"), os.path.join(tmp, "run"))
        shutil.copytree(os.path.join(fixture, "data"), os.path.join(tmp, "data"))
        stats = predict_shapes_device(os.path.join(tmp, "run"), data_path=os.path.join(tmp, "data"),
                                      batch_size=64, compute_dtype="float32", device="cpu")
        assert stats["n_patches"] == 400

        import json, zlib, struct, contextlib, io
        from nestinet_tpu_torch.cli import evaluate, scan, synth, test_all
        run, synth_root = os.path.join(tmp, "run"), os.path.join(tmp, "synth")
        synth.main(["--root", synth_root, "--n_points", "60", "--n_pidx", "10"])
        with open(os.path.join(synth_root, "lists.txt"), "w") as f:
            f.write("testset.txt" + chr(10))
        test_all.main(["--results_path", run, "--dataset_path", synth_root, "--testset_list",
                       "lists.txt", "--dataset_name", "s", "--batch_size", "64", "--device", "cpu"])
        results = os.path.join(run, "s_results")
        evaluate.main(["--normal_results_path", results, "--data_path", synth_root,
                       "--expert_statistics", "1", "--n_experts", "2"])
        with open(os.path.join(results, "images", "expert_statistics",
                               "testset_expert_statistics.json")) as f:
            assert sum(json.load(f)["count"]) == 6 * 10
        depth = (1000 + 10 * np.arange(12 * 16).reshape(12, 16)).astype(">u2")
        raw = b"".join(bytes(1) + row.tobytes() for row in depth)  # filter 0 rows
        chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
        with open(os.path.join(tmp, "d.png"), "wb") as f:
            f.write(bytes([137, 80, 78, 71, 13, 10, 26, 10]) + chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 12, 16, 0, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        np.savetxt(os.path.join(tmp, "k.txt"), [[10.0, 0, 8], [0, 10.0, 6], [0, 0, 1]])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            scan.main(["--results_path", run, "--depth", os.path.join(tmp, "d.png"),
                       "--intrinsic", os.path.join(tmp, "k.txt"), "--depth_shift", "1000",
                       "--batch_size", "64", "--project_to_image", "1", "--device", "cpu"])
        assert json.loads(out.getvalue())["n_points"] == 12 * 16
        from nestinet_tpu_torch.data import augment, ply, pointcloud, rotations
        pts = np.random.RandomState(0).uniform(-1, 1, (2, 32, 3)).astype(np.float32)
        ply.write_ply(os.path.join(tmp, "p.ply"), pts[0], normals=pts[1])
        assert np.array_equal(ply.read_ply_points(os.path.join(tmp, "p.ply")), pts[0])
        assert pointcloud.point_cloud_to_volume(pts[0], 4).sum() > 0
        assert np.allclose(rotations.quat2mat(rotations.euler2quat(0.3, 0.2, 0.1)),
                           rotations.euler2mat(0.3, 0.2, 0.1))
        rng = np.random.RandomState(1)
        assert augment.occlude(augment.jitter(pts, rng), rng, 0.25).shape == (2, 24, 3)
    assert all(sys.modules.get(n) is None for n in BLOCKED)
    print("NOJAX_OK")
    """
)


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout


def _port_files():
    files = sorted(glob.glob(os.path.join(REPO, "nestinet_tpu_torch", "**", "*.py"),
                             recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")]


BLOCKED = ("nestinet_tpu", "jax", "jaxlib", "haiku", "flax", "optax", "msgpack", "PIL",
           "matplotlib", "tensorboard", "sklearn")


def _jax_package_imports(path):
    """(line, module) of every import of `nestinet_tpu`, of JAX and its
    libraries (`BLOCKED`) or of a submodule of one in the file, at any
    depth (inside functions too)."""
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if any(n == b or n.startswith(b + ".") for b in BLOCKED)]
    return found


def test_port_files_import_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    bad = {os.path.relpath(p, REPO): hits for p in files if (hits := _jax_package_imports(p))}
    assert not bad, bad


@pytest.mark.parametrize("source", [
    "import nestinet_tpu",
    "import nestinet_tpu.core.config as c",
    "from nestinet_tpu.data import loader",
    "def f():\n    from nestinet_tpu.eval.evaluate import evaluate_dataset",
    "import jax",
    "import jax.numpy as jnp",
    "def f():\n    import jaxlib",
    "import haiku as hk",
    "from flax import serialization",
    "def f():\n    from flax.serialization import msgpack_restore",
    "import optax",
    "def f():\n    import msgpack",
    "from PIL import Image",
    "import matplotlib.pyplot as plt",
    "def f():\n    from tensorboard.compat.proto.event_pb2 import Event",
    "def f():\n    from sklearn.mixture import GaussianMixture",
])
def test_the_scan_finds_an_import_of_the_jax_package(tmp_path, source):
    path = tmp_path / "mod.py"
    path.write_text(source + "\nimport nestinet_tpu_torch\nimport jaxtyping\nimport flaxen\n")
    assert len(_jax_package_imports(str(path))) == 1
