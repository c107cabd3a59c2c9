"""Evaluation harness over predicted `.normals` files.

A copy of `nestinet_tpu/eval/evaluate.py`, so the port scores its own
outputs; its visualization export (`export=True`) draws with the port's
`viz/` on its NumPy canvas and writes the JAX package's files.  Parity with
`utils/evaluate.py`: per dataset list, load GT `.xyz/.normals` +
predicted `.normals` + `.pidx` sparse-eval indices, subset to pidx,
compute unoriented/oriented RMS and PGP5/PGP10 per shape, and write
`summary/<set>_evaluation_results.txt` in the same format.  Returns the
numbers as a dict for programmatic use.
"""

from __future__ import annotations

import os

import numpy as np

from .metrics import angle_errors_deg, pgp, rms_angle_deg, unoriented_flip


def _export_shape(
    data_path, results_path, shape, points_idx,
    normals_gt, normals_pred, experts, n_experts, *, sparse, footnote,
):
    """Per-shape visual export: (phi, theta)-domain plots + cloud
    renders (reference `utils/evaluate.py:161-185` + the MATLAB
    pipeline)."""
    from ..viz.clouds import export_shape_visualizations
    from ..viz.normals import (
        discrete_cmap,
        draw_line_segments,
        draw_phi_theta_domain,
        euclidean_to_spherical,
    )

    vis_dir = os.path.join(results_path, "images")
    phi_dir = os.path.join(vis_dir, "phi_theta")
    os.makedirs(phi_dir, exist_ok=True)

    # Sign-align predictions with GT before mapping to the sphere
    # (unoriented protocol; reference `evaluate.py:152-158`).
    pred_aligned = unoriented_flip(normals_pred, normals_gt)
    phi_gt, theta_gt = euclidean_to_spherical(normals_gt)
    phi_pr, theta_pr = euclidean_to_spherical(pred_aligned)

    ax = draw_phi_theta_domain(
        phi_gt, theta_gt, color="k",
        title=r"$\theta(\phi)$ " + shape,
    )
    draw_line_segments(phi_gt, theta_gt, phi_pr, theta_pr, ax=ax,
                       footnote=footnote)
    if experts is not None:
        draw_phi_theta_domain(
            phi_pr, theta_pr, color=experts, ax=ax,
            cmap=discrete_cmap(n_experts), n_labels=n_experts,
            filename=os.path.join(phi_dir, shape + "_phi_theta_domain"),
        )
    else:
        draw_phi_theta_domain(
            phi_pr, theta_pr, color="r", ax=ax,
            filename=os.path.join(phi_dir, shape + "_phi_theta_domain"),
        )

    points = np.loadtxt(os.path.join(data_path, shape + ".xyz"))
    if sparse:
        points = points[points_idx]
    ang, _ = angle_errors_deg(normals_gt, normals_pred)
    export_shape_visualizations(
        points, normals_gt, pred_aligned, vis_dir, shape,
        experts=experts, n_experts=n_experts, angle_errors=ang,
    )


def evaluate_dataset(
    data_path: str,
    results_path: str,
    dataset: str,
    *,
    sparse_patches: bool = True,
    export: bool = False,
    n_experts: int = 7,
    log=print,
) -> dict:
    """Metric pass over one dataset list.

    With `export=True`, additionally writes per-shape (phi, theta)-domain
    plots (GT->prediction segments, expert-colored predictions when
    `.experts` files exist) and normal/error/expert cloud renders —
    parity with the reference's EXPORT branch (`utils/evaluate.py:161-185`)
    plus the MATLAB render pipeline (`MATLAB/export_visualizations.m`).
    """
    list_path = os.path.join(data_path, dataset + ".txt")
    if not os.path.exists(list_path):
        raise FileNotFoundError(
            f"dataset list '{dataset}' not found: no {list_path}. "
            f"--dataset_list entries name <data_path>/<name>.txt files; "
            f"canonical PCPNet sets: {', '.join(PCPNET_TEST_SETS)}"
        )
    with open(list_path) as f:
        shape_names = [x.strip() for x in f.readlines() if x.strip()]

    outdir = os.path.join(results_path, "summary")
    os.makedirs(outdir, exist_ok=True)

    rms, rms_o, pgp10, pgp5 = [], [], [], []
    for shape in shape_names:
        normals_gt = np.loadtxt(os.path.join(data_path, shape + ".normals")).astype(
            np.float32
        )
        normals_pred = np.loadtxt(
            os.path.join(results_path, shape + ".normals")
        ).astype(np.float32)
        points_idx = np.loadtxt(os.path.join(data_path, shape + ".pidx")).astype(int)

        experts = None
        experts_path = os.path.join(results_path, shape + ".experts")
        if os.path.exists(experts_path):
            experts = np.loadtxt(experts_path).astype(int)

        sparse_normals = normals_pred.shape[0] != normals_gt.shape[0]
        if sparse_normals:
            # predictions cover only the pidx subset
            normals_gt = normals_gt[points_idx]
        elif sparse_patches:
            normals_gt = normals_gt[points_idx]
            normals_pred = normals_pred[points_idx]
            if experts is not None:
                experts = experts[points_idx]
        # else: dense predictions + sparse_patches=False -> evaluate every
        # point.  (The reference crashed here — it subset GT but not the
        # dense predictions, `utils/evaluate.py:127-132`; fix-not-copy.)

        ang, ang_o = angle_errors_deg(normals_gt, normals_pred)
        rms.append(rms_angle_deg(ang))
        rms_o.append(rms_angle_deg(ang_o))
        pgp10.append(pgp(ang, 10.0))
        pgp5.append(pgp(ang, 5.0))

        if export:
            _export_shape(
                data_path, results_path, shape, points_idx,
                normals_gt, normals_pred, experts, n_experts,
                sparse=sparse_patches or sparse_normals,
                footnote=(
                    f"RMS unoriented= {rms[-1]:.3f}, "
                    f"PGP5= {pgp5[-1]:.3f}, PGP10= {pgp10[-1]:.3f}"
                ),
            )

    summary = {
        "dataset": dataset,
        "shapes": shape_names,
        "rms_per_shape": rms,
        "rms": float(np.mean(rms)),
        "rms_oriented": float(np.mean(rms_o)),
        "pgp10_per_shape": pgp10,
        "pgp5_per_shape": pgp5,
        "pgp10": float(np.mean(pgp10)),
        "pgp5": float(np.mean(pgp5)),
    }

    out_file = os.path.join(outdir, dataset + "_evaluation_results.txt")
    with open(out_file, "w") as f:
        def log_string(s):
            f.write(s + "\n")
            log(s)

        log_string("RMS per shape: " + str(rms))
        log_string("RMS not oriented (shape average): " + str(summary["rms"]))
        log_string("RMS oriented (shape average): " + str(summary["rms_oriented"]))
        log_string("PGP10 per shape: " + str(pgp10))
        log_string("PGP5 per shape: " + str(pgp5))
        log_string("PGP10 average: " + str(summary["pgp10"]))
        log_string("PGP5 average: " + str(summary["pgp5"]))
    return summary


def evaluate_datasets(
    data_path: str,
    results_path: str,
    dataset_list,
    *,
    sparse_patches: bool = True,
    export: bool = False,
    n_experts: int = 7,
    log=print,
) -> list[dict]:
    return [
        evaluate_dataset(
            data_path, results_path, d, sparse_patches=sparse_patches,
            export=export, n_experts=n_experts, log=log,
        )
        for d in dataset_list
    ]


# The canonical PCPNet benchmark sets (`utils/evaluate.py:40-41`).
PCPNET_TEST_SETS = [
    "testset",
    "testset_whitenoise_small",
    "testset_whitenoise_medium",
    "testset_whitenoise_large",
    "testset_vardensity_gradient",
    "testset_vardensity_striped",
]
