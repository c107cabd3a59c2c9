"""The port imports no JAX, haiku or flax, directly or through anything it
imports: the GPU machine it serves on has none of them.

A subprocess blocks those packages in `sys.modules` before anything else,
imports every module of the port, and runs a tiny CPU forward, dense and
routed on device-extracted patches, then the same model folded and in int8.
"""

import os
import subprocess
import sys
import textwrap

SCRIPT = textwrap.dedent(
    """
    import sys
    for name in ("jax", "jaxlib", "haiku", "flax", "optax", "msgpack"):
        sys.modules[name] = None  # any import of them now raises ImportError

    import importlib
    for mod in (
        "nestinet_tpu_torch",
        "nestinet_tpu_torch.core.device",
        "nestinet_tpu_torch.core.checkpoint",
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
        "nestinet_tpu_torch.convert",
        "nestinet_tpu_torch.infer.writer",
        "nestinet_tpu_torch.infer.predict",
        "nestinet_tpu_torch.infer.device_pipeline",
        "nestinet_tpu_torch.ops.ball_query",
        "nestinet_tpu_torch.scripts.mups_kernel_exp",
        "nestinet_tpu_torch.cli.test",
        "nestinet_tpu.eval.evaluate",
        "nestinet_tpu.data.synthetic",
    ):
        importlib.import_module(mod)

    import torch
    torch.set_num_threads(1)
    from nestinet_tpu.core.config import Config
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.models.base import init_params
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    cfg = Config(tiny_backbone=True, num_point=8, num_gaussians=3)
    model = build_model(cfg, get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9))
    init_params(model, torch.Generator().manual_seed(0))
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
    assert all(sys.modules.get(n) is None for n in ("jax", "haiku", "flax"))
    print("NOJAX_OK")
    """
)


def test_port_imports_and_runs_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        timeout=300, cwd=repo,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout
