"""Per-expert error / usage statistics for MoE results.

A copy of `nestinet_tpu/eval/expert_stats.py` (the Python absorption of
`MATLAB/compute_expert_statistics.m`) that writes the same JSON summary:
for each shape of a dataset list, load GT normals, predicted `.normals`
and the winning-expert ids (`.experts`) written by the MoE inference
path, subset to the `.pidx` evaluation points, and accumulate per-expert
angular-error sums and usage counts (angle formula parity:
`compute_expert_statistics.m:60-67`).  The JAX package also draws bar
charts with matplotlib; those are not ported (ROADMAP queue 1, item 4),
and `export_plots=True` raises NotImplementedError.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .metrics import angle_errors_deg


def expert_statistics_for_shape(
    normals_gt: np.ndarray,
    normals_pred: np.ndarray,
    experts: np.ndarray,
    n_experts: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(error_sum[n_experts], count[n_experts]) over one shape."""
    ang, _ = angle_errors_deg(normals_gt, normals_pred)
    experts = np.asarray(experts, dtype=int).reshape(-1)
    error_sum = np.zeros(n_experts)
    count = np.zeros(n_experts, dtype=np.int64)
    for e in range(n_experts):
        mask = experts == e
        error_sum[e] = float(ang[mask].sum())
        count[e] = int(mask.sum())
    return error_sum, count


def compute_expert_statistics(
    data_path: str,
    results_path: str,
    dataset: str,
    *,
    n_experts: int = 7,
    use_subset: bool = True,
    export_plots: bool = False,
    log=print,
) -> dict:
    """Aggregate per-expert statistics over a dataset list and write
    `<results>/images/expert_statistics/<dataset>_expert_statistics.json`.

    Mirrors the MATLAB loop (`compute_expert_statistics.m`):
    sparse predictions are aligned to the `.pidx` subset; dense
    predictions are optionally subset (use_subset) for comparability.
    """
    if export_plots:
        raise NotImplementedError(
            "the expert-statistics bar charts need matplotlib, not ported: "
            "ROADMAP.md queue 1, item 4 (the matplotlib renders)"
        )
    with open(os.path.join(data_path, dataset + ".txt")) as f:
        shapes = [s.strip() for s in f if s.strip()]

    total_err = np.zeros(n_experts)
    total_cnt = np.zeros(n_experts, dtype=np.int64)
    per_shape = {}
    for shape in shapes:
        log(f"expert statistics: {shape}")
        gt = np.loadtxt(os.path.join(data_path, shape + ".normals"))
        pred = np.loadtxt(os.path.join(results_path, shape + ".normals"))
        experts = np.loadtxt(os.path.join(results_path, shape + ".experts"))
        pidx = np.loadtxt(os.path.join(data_path, shape + ".pidx")).astype(int)

        if pred.shape[0] != gt.shape[0]:  # sparse predictions
            gt = gt[pidx]
        elif use_subset:
            gt, pred, experts = gt[pidx], pred[pidx], experts[pidx]

        err_sum, cnt = expert_statistics_for_shape(gt, pred, experts, n_experts)
        total_err += err_sum
        total_cnt += cnt
        with np.errstate(invalid="ignore", divide="ignore"):
            avg = np.where(cnt > 0, err_sum / np.maximum(cnt, 1), np.nan)
        per_shape[shape] = {
            "avg_error_deg": avg.tolist(),
            "count": cnt.tolist(),
        }

    with np.errstate(invalid="ignore", divide="ignore"):
        total_avg = np.where(
            total_cnt > 0, total_err / np.maximum(total_cnt, 1), np.nan
        )
    summary = {
        "dataset": dataset,
        "n_experts": n_experts,
        "avg_error_deg": np.nan_to_num(total_avg).tolist(),
        "count": total_cnt.tolist(),
        "usage_fraction": (
            total_cnt / max(int(total_cnt.sum()), 1)
        ).tolist(),
        "per_shape": per_shape,
    }
    outdir = os.path.join(results_path, "images", "expert_statistics")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{dataset}_expert_statistics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
