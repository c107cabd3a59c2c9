"""Evaluation harness over predicted `.normals` files.

A copy of `nestinet_tpu/eval/evaluate.py`, so the port scores its own
outputs.  Its visualization export (`export=True`) needs matplotlib and
the JAX package's `viz/` renders, which are not ported (ROADMAP queue 1,
item 4, the matplotlib renders):
it raises NotImplementedError.  Parity with
`utils/evaluate.py`: per dataset list, load GT `.xyz/.normals` +
predicted `.normals` + `.pidx` sparse-eval indices, subset to pidx,
compute unoriented/oriented RMS and PGP5/PGP10 per shape, and write
`summary/<set>_evaluation_results.txt` in the same format.  Returns the
numbers as a dict for programmatic use.
"""

from __future__ import annotations

import os

import numpy as np

from .metrics import angle_errors_deg, pgp, rms_angle_deg


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
    """Metric pass over one dataset list.  `export=True` raises
    NotImplementedError (see the module docstring); `n_experts` is used by
    the export only."""
    if export:
        raise NotImplementedError(
            "the visualization export (plots and renders) needs matplotlib and "
            "the viz/ renders, not ported: ROADMAP.md queue 1, item 4 (the matplotlib renders)"
        )
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

        sparse_normals = normals_pred.shape[0] != normals_gt.shape[0]
        if sparse_normals:
            # predictions cover only the pidx subset
            normals_gt = normals_gt[points_idx]
        elif sparse_patches:
            normals_gt = normals_gt[points_idx]
            normals_pred = normals_pred[points_idx]
        # else: dense predictions + sparse_patches=False -> evaluate every
        # point.  (The reference crashed here — it subset GT but not the
        # dense predictions, `utils/evaluate.py:127-132`; fix-not-copy.)

        ang, ang_o = angle_errors_deg(normals_gt, normals_pred)
        rms.append(rms_angle_deg(ang))
        rms_o.append(rms_angle_deg(ang_o))
        pgp10.append(pgp(ang, 10.0))
        pgp5.append(pgp(ang, 5.0))

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
