"""Per-expert error / usage statistics for MoE results.

A copy of `nestinet_tpu/eval/expert_stats.py` (the Python absorption of
`MATLAB/compute_expert_statistics.m`) that writes the same JSON summary:
for each shape of a dataset list, load GT normals, predicted `.normals`
and the winning-expert ids (`.experts`) written by the MoE inference
path, subset to the `.pidx` evaluation points, and accumulate per-expert
angular-error sums and usage counts (angle formula parity:
`compute_expert_statistics.m:60-67`).  With `export_plots` (the default,
as in the JAX package) it also draws the per-shape and aggregate bar
charts, on the port's NumPy canvas (`viz/canvas.py`), as PNG.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..viz.canvas import subplots
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


def _bar(values, *, title, ylabel, filename, n_experts):
    fig, ax = subplots(figsize=(6, 4))
    ax.bar(np.arange(n_experts), values)
    ax.set_xticks(range(n_experts))
    ax.set_xlabel("expert")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.savefig(filename, dpi=150, bbox_inches="tight")


def compute_expert_statistics(
    data_path: str,
    results_path: str,
    dataset: str,
    *,
    n_experts: int = 7,
    use_subset: bool = True,
    export_plots: bool = True,
    log=print,
) -> dict:
    """Aggregate per-expert statistics over a dataset list and write
    `<results>/images/expert_statistics/<dataset>_expert_statistics.json`;
    with `export_plots`, also `avg_error/<shape>.png`,
    `point_count/<shape>.png`, `avg_error_all.png` and
    `point_count_all.png` there.

    Mirrors the MATLAB loop (`compute_expert_statistics.m`):
    sparse predictions are aligned to the `.pidx` subset; dense
    predictions are optionally subset (use_subset) for comparability.
    """
    with open(os.path.join(data_path, dataset + ".txt")) as f:
        shapes = [s.strip() for s in f if s.strip()]

    outdir = os.path.join(results_path, "images", "expert_statistics")
    avg_dir = os.path.join(outdir, "avg_error")
    cnt_dir = os.path.join(outdir, "point_count")
    if export_plots:
        os.makedirs(avg_dir, exist_ok=True)
        os.makedirs(cnt_dir, exist_ok=True)

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
        if export_plots:
            _bar(np.nan_to_num(avg), title=f"Average expert error — {shape}",
                 ylabel="average error [deg]",
                 filename=os.path.join(avg_dir, shape + ".png"),
                 n_experts=n_experts)
            _bar(cnt, title=f"Expert point count — {shape}",
                 ylabel="points per expert",
                 filename=os.path.join(cnt_dir, shape + ".png"),
                 n_experts=n_experts)

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
    if export_plots:
        _bar(np.nan_to_num(total_avg), title="Average expert error (all shapes)",
             ylabel="average error [deg]",
             filename=os.path.join(outdir, "avg_error_all.png"),
             n_experts=n_experts)
        _bar(total_cnt, title="Expert point count (all shapes)",
             ylabel="points per expert",
             filename=os.path.join(outdir, "point_count_all.png"),
             n_experts=n_experts)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{dataset}_expert_statistics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
