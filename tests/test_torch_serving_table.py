"""What each model serves and writes, in each mode, on both extraction paths.

The serving job asks the model (`models/base.py::ModelBase`'s serving
attributes and `serve_dense`) whether it is routed, which files it writes
and under which stats key it counts its routes:

| model | `sparse` | `dense` |
|---|---|---|
| mixture of experts | `.normals`, `.experts`, `.experts_probs`; `expert_rows` | the same |
| switching | `.normals`, `.experts` (the branch), `.noise`; `branch_rows` | `.normals`; `branch_rows` |
| single-scale, multi-scale | `.normals` | `.normals` |

Each case serves a tiny run dir made by the port alone (weights from the
config's seed, the ablation backbones narrowed to `TINY` as in
`tests/test_torch_ablations.py`) through `predict_shapes` and
`predict_shapes_device` on the CPU, over the `.pidx` subsets of two
synthetic shapes.
"""

import os

import numpy as np
import pytest
import torch

from nestinet_tpu_torch.core import checkpoint
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.core.rundir import RunDir
from nestinet_tpu_torch.data.synthetic import build_protocol_benchmark
from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
from nestinet_tpu_torch.infer.predict import predict_shapes
from nestinet_tpu_torch.models import build_model
from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

from .test_torch_ablations import narrow_backbones
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

RADII = {"experts_n_est": (0.05, 0.1, 0.2), "ms_sw_n_est": (0.05, 0.2),
         "ss_norm_est": (0.1,), "ms_norm_est": (0.05, 0.1, 0.2)}
MOE = ({"normals", "experts", "experts_probs"}, "expert_rows")
# (model, moe_inference) -> (the suffixes written a shape, the routes' stats key)
TABLE = {
    ("experts_n_est", "sparse"): MOE,
    ("experts_n_est", "dense"): MOE,
    ("ms_sw_n_est", "sparse"): ({"normals", "experts", "noise"}, "branch_rows"),
    ("ms_sw_n_est", "dense"): ({"normals"}, "branch_rows"),
    ("ss_norm_est", "sparse"): ({"normals"}, None),
    ("ss_norm_est", "dense"): ({"normals"}, None),
    ("ms_norm_est", "sparse"): ({"normals"}, None),
    ("ms_norm_est", "dense"): ({"normals"}, None),
}
N_PIDX = 40


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(data dir, {model: run dir})."""
    root = str(tmp_path_factory.mktemp("serving_table"))
    data = os.path.join(root, "data")
    sets = build_protocol_benchmark(data, n_points=200, n_pidx=N_PIDX, seed=6)
    with open(os.path.join(data, "two.txt"), "w") as f:
        f.write("\n".join(sets["testset.txt"][:2]) + "\n")
    out = {}
    with narrow_backbones():
        for model, radii in RADII.items():
            cfg = Config(model=model, tiny_backbone=True, log_dir=os.path.join(root, model),
                         data_path=data, num_gaussians=3, gmm_variance=1.0 / 9, num_point=16,
                         patch_radius=radii)
            rd = RunDir.create(cfg.log_dir)
            cfg.save(rd.config_path)
            gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
            gmm.save(rd.gmm_path)
            checkpoint.save(rd.path, build_model(cfg, gmm).state_dict())
            out[model] = rd.path
    return data, out


@pytest.mark.parametrize("extraction", ["host", "device"])
@pytest.mark.parametrize("model,moe_inference", sorted(TABLE))
def test_model_decides_what_is_served_and_written(runs, tmp_path, model, moe_inference,
                                                  extraction):
    data, run_dirs = runs
    suffixes, stat = TABLE[(model, moe_inference)]
    kw = dict(testset="two.txt", data_path=data, batch_size=32, sparse_patches=True,
              output_dir=str(tmp_path / "out"), moe_inference=moe_inference,
              compute_dtype="float32", device="cpu")
    with narrow_backbones():
        if extraction == "host":
            stats = predict_shapes(run_dirs[model], loader_workers=2, **kw)
        else:
            stats = predict_shapes_device(run_dirs[model], **kw)
    assert stats["n_patches"] == 2 * N_PIDX and len(stats["shapes"]) == 2
    written = {}
    for name in os.listdir(stats["output_dir"]):
        shape, suffix = name.rsplit(".", 1)
        written.setdefault(shape, set()).add(suffix)
    assert written == {s: suffixes for s in stats["shapes"]}
    for key in ("expert_rows", "branch_rows"):
        assert (key in stats) == (key == stat)
    if stat == "expert_rows":
        assert len(stats[stat]) == 7 and sum(stats[stat]) == stats["n_patches"]
    elif stat == "branch_rows":
        assert set(stats[stat]) == {"small_scale", "large_scale"}
        assert sum(stats[stat].values()) == stats["n_patches"]
    routed = moe_inference == "sparse" and stat is not None
    assert ("expert_runs" in stats) == routed
    for gate_file in suffixes - {"normals", "experts"}:  # the gate's columns, a row a patch
        base = os.path.join(stats["output_dir"], stats["shapes"][0])
        ids = np.loadtxt(base + ".experts")
        gate = np.loadtxt(f"{base}.{gate_file}", ndmin=2)
        assert ids.shape == (N_PIDX,) and gate.shape == (N_PIDX, 7 if stat == "expert_rows" else 1)
