"""The port's serving in bfloat16 against the JAX package's, end to end on
the CPU: host routed (`predict_shapes`, sparse), host dense, and device
extraction routed (`predict_shapes_device`), on one tiny-backbone run dir
over the synthetic protocol testset (random weights and BatchNorm state,
manager logits spread so that patches route to several experts).

JAX serves through its jitted programs, where XLA may keep float32 inside
a fused elementwise chain (excess precision), while the port rounds every
op to bfloat16 as JAX's eager ops do (`tests/test_torch_dtypes.py` holds
the port to eager JAX to the last bit).  So most patches agree exactly,
and a few differ where a fused rounding fell otherwise; under int8 such a
difference moves a layer's per-tensor activation scale and with it every
patch of that batch.  The bars (`Bars`), measured values in brackets:
  * the share of patches whose probabilities equal JAX's within 1e-6:
    bfloat16 >= 0.99 [1795-1798 of 1800; 1793 with BN folded], int8 >=
    0.85 [1654 on the host paths, 1772 on the device path];
  * the largest probability difference below JAX's own gap between
    neighbouring modes on the same run: 0.1 for bfloat16 [0.057; JAX's
    bfloat16 against its float32: 0.18], 0.5 for int8 [0.45; JAX's int8
    against its bfloat16: 0.455];
  * `.experts` identical wherever JAX's top-2 margin exceeds 0.05 [all],
    under int8 on 99% of those patches [8 of 1606 and 3 of 1609 differ];
  * where the ids agree, each normal's direction within 2 degrees [0.64],
    5 under int8 [1.47 dense; 4.05 routed, where a routed expert's
    sub-batch is not JAX's FIFO window, so its activation scales differ;
    JAX's own int8 against its bfloat16: 3.7, and `tests/test_int8.py`
    allows 10], counting patches whose normal is not near zero;
  * the RMS angle against the ground truth within 0.5 degrees.
The tests print what they measure.  `tests/test_torch_serve_int8.py` and
`test_torch_serve_fold.py` run the same checks in int8 and in bfloat16
with BatchNorm folded.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nestinet_tpu.eval.evaluate import evaluate_dataset
from nestinet_tpu.infer.device_pipeline import predict_shapes_device as jax_predict_device
from nestinet_tpu.infer.predict import predict_shapes as jax_predict_shapes
from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
from nestinet_tpu_torch.infer.predict import predict_shapes

from .test_torch_slice import BATCH, N_POINTS, build_data, build_run
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

PATHS = ("host_sparse", "host_dense", "device_sparse")
MARGIN = 0.05
RMS_DEG = 0.5


@dataclasses.dataclass(frozen=True)
class Bars:
    exact_share: float  # patches whose probabilities equal JAX's within 1e-6
    probs_atol: float
    sure_ids_share: float  # ids equal among patches with a clear margin
    angle_deg: float


BF16_BARS = Bars(exact_share=0.99, probs_atol=0.1, sure_ids_share=1.0, angle_deg=2.0)
INT8_BARS = Bars(exact_share=0.85, probs_atol=0.5, sure_ids_share=0.99, angle_deg=5.0)


def serve_both(tmp_path_factory, tag: str, compute_dtype: str, fold_bn: bool):
    """Serve one run dir three ways with JAX and with the port in one
    mode; returns (data dir, {path: (jax stats, port stats)})."""
    root = str(tmp_path_factory.mktemp(f"torch_serve_{tag}"))
    data = build_data(root)
    run_path = build_run(root, data)
    mode = dict(compute_dtype=compute_dtype, fold_bn=fold_bn)
    out = {}
    for path in PATHS:
        kw = dict(testset="testset.txt", data_path=data, batch_size=BATCH,
                  moe_inference=path.split("_")[1], **mode)
        if path.startswith("host"):
            jax_fn, port_fn = jax_predict_shapes, predict_shapes
            kw["loader_workers"] = 2
        else:
            jax_fn, port_fn = jax_predict_device, predict_shapes_device
        out[path] = (
            jax_fn(run_path, output_dir=os.path.join(root, "jax_" + path), **kw),
            port_fn(run_path, output_dir=os.path.join(root, path), device="cpu", **kw),
        )
    return data, out


def _load(stats, shape, ext):
    return np.loadtxt(os.path.join(stats["output_dir"], shape + ext))


def check_against_jax(data, jax_stats, port, compute_dtype, fold_bn, bars: Bars):
    assert port["n_patches"] == jax_stats["n_patches"] == 6 * N_POINTS
    assert port["shapes"] == jax_stats["shapes"]
    assert port["compute_dtype"] == compute_dtype and port["fold_bn"] is fold_bn
    n_exact = n_sure = n_sure_same = n_same = 0
    worst_prob = worst_angle = 0.0
    ids = []
    for shape in port["shapes"]:
        want_p, got_p = _load(jax_stats, shape, ".experts_probs"), _load(port, shape, ".experts_probs")
        want_id, got_id = _load(jax_stats, shape, ".experts"), _load(port, shape, ".experts")
        want_n, got_n = _load(jax_stats, shape, ".normals"), _load(port, shape, ".normals")
        assert np.isfinite(got_n).all() and np.isfinite(got_p).all()
        ids.append(got_id)
        diff = np.abs(got_p - want_p).max(axis=1)
        n_exact += (diff <= 1e-6).sum()
        worst_prob = max(worst_prob, diff.max())
        top2 = np.sort(want_p, axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN
        n_sure += sure.sum()
        n_sure_same += (got_id[sure] == want_id[sure]).sum()
        n_same += (got_id == want_id).sum()
        norm = np.linalg.norm(want_n, axis=1)
        keep = (got_id == want_id) & (norm > 0.1 * norm.max())
        cos = (got_n[keep] * want_n[keep]).sum(1) / (
            np.linalg.norm(got_n[keep], axis=1) * norm[keep])
        angle = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        worst_angle = max(worst_angle, angle.max(initial=0.0))
    quiet = lambda *_: None  # noqa: E731
    rms = (evaluate_dataset(data, port["output_dir"], "testset", log=quiet)["rms"],
           evaluate_dataset(data, jax_stats["output_dir"], "testset", log=quiet)["rms"])
    n = port["n_patches"]
    print(f"{compute_dtype} fold_bn={fold_bn} {port['moe_inference']}: probabilities equal "
          f"on {n_exact}/{n}, max abs diff {worst_prob:.3e}; ids equal {n_same}/{n}, with a "
          f"margin > {MARGIN} {n_sure_same}/{n_sure}; normals max angle {worst_angle:.3f} deg; "
          f"RMS {rms[0]:.4f} against JAX {rms[1]:.4f}")
    assert n_exact >= bars.exact_share * n
    assert worst_prob <= bars.probs_atol
    assert n_sure > 0.5 * n and n_sure_same >= bars.sure_ids_share * n_sure
    assert len(np.unique(np.concatenate(ids))) >= 3  # routing spreads
    assert worst_angle <= bars.angle_deg
    assert abs(rms[0] - rms[1]) <= RMS_DEG


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return serve_both(tmp_path_factory, "bf16", "bfloat16", False)


@pytest.mark.parametrize("path", PATHS)
def test_bf16_serving_matches_jax(served, path):
    data, out = served
    check_against_jax(data, *out[path], "bfloat16", False, BF16_BARS)


def test_bf16_routed_equals_dense(served):
    """In bfloat16 the routed experts compute what the dense ones do on
    the same rows: ids identical, normals within 1e-2 (cuDNN or oneDNN may
    sum a sub-batch in another order)."""
    _, out = served
    sparse, dense = out["host_sparse"][1], out["host_dense"][1]
    for shape in sparse["shapes"]:
        np.testing.assert_array_equal(_load(sparse, shape, ".experts"),
                                      _load(dense, shape, ".experts"))
        np.testing.assert_allclose(_load(sparse, shape, ".normals"),
                                   _load(dense, shape, ".normals"), atol=1e-2, rtol=1e-2)
