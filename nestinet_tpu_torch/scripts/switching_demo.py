"""Switching-mechanism demonstration of the PyTorch port: the hard switch
firing, measured.

Counterpart of `scripts/switching_demo.py`, with its flags plus `--device
{cuda,cpu}` (default cuda).  The noise-switching model picks the
small-scale branch iff its noise head predicts < 0.015
(`models/switching.py::NOISE_SWITCH_THRESHOLD`, the reference's
`ms_sw_n_est.py:82-84`); on the canonical PCPNet noise levels (all below
it) a correct switch routes everything one way, so the mechanism shows only
on sigmas on both sides of the threshold: `cli.synth --switching`
(`data/synthetic.py::build_switching_benchmark`).

It serves a trained `ms_sw_n_est` run dir (`infer/predict.py::load_run`)
over `testset_switching.txt`, each shape's `.pidx` patches with their
ground-truth normals, and prints, per GT noise level, the mean predicted
noise (the noise head's calibration), the share of patches routed through
the small-scale branch and the unoriented RMS angle error, then the
per-shape Pearson correlation between predicted and GT noise, the overall
share and RMS, and JAX's JSON line with the same keys.

Usage:
    python -m nestinet_tpu_torch.scripts.switching_demo <run_dir>
        [--data data/synth_switching] [--batch 256]
        [--testset testset_switching.txt] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir")
    ap.add_argument("--data", default="data/synth_switching")
    ap.add_argument("--testset", default="testset_switching.txt")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    """Print the table, the closing lines and the JSON line; returns that
    line's object plus "patches_per_sigma" ({sigma: patches served}) and
    "seconds"."""
    args = build_parser().parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from nestinet_tpu_torch.core.device import resolve_device, set_f32_numerics
    from nestinet_tpu_torch.data.loader import get_data_loader
    from nestinet_tpu_torch.data.pcpnet import read_noise_levels, read_shape_list
    from nestinet_tpu_torch.infer.predict import load_run, pad_batch
    from nestinet_tpu_torch.models.switching import NOISE_SWITCH_THRESHOLD, SwitchingNormEst

    dev = resolve_device(args.device)
    set_f32_numerics()
    rd, cfg, gmm, model = load_run(args.run_dir, dev)
    if not isinstance(model, SwitchingNormEst):
        raise ValueError(f"run is {cfg.model}, not ms_sw_n_est")

    shape_names = read_shape_list(args.data, args.testset)
    gt_sigma = read_noise_levels(args.data, args.testset, len(shape_names))

    loader, dataset = get_data_loader(
        args.testset, indir=args.data, batch_size=args.batch,
        patch_radius=cfg.patch_radius, points_per_patch=cfg.num_point,
        outputs=("unoriented_normals",),  # GT normals ride along per patch
        seed=cfg.seed, patch_sample_order="full", workers=8,
        sparse_patches=True,
    )

    noise_pred, ang_err = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for batch in loader:
            real = batch["points"].shape[0]
            padded = pad_batch(batch, args.batch)
            points = torch.from_numpy(padded["points"]).to(dev)
            n_eff = torch.from_numpy(padded["n_eff"].astype(np.int32)).to(dev)
            outputs = model(points, n_eff)
            n = outputs["n_pred"]
            n = n / torch.clamp(torch.linalg.vector_norm(n, dim=1, keepdim=True), min=1e-12)
            out = torch.cat([n, outputs["noise_pred"][:, None]], dim=1).cpu().numpy()[:real]
            gt = batch["normals"] / np.maximum(
                np.linalg.norm(batch["normals"], axis=1, keepdims=True), 1e-12
            )
            cos = np.clip(np.abs(np.sum(out[:, :3] * gt, axis=1)), -1, 1)
            ang_err.append(np.degrees(np.arccos(cos)))
            noise_pred.append(out[:, 3])
    noise_pred = np.concatenate(noise_pred)
    ang_err = np.concatenate(ang_err)
    seconds = time.perf_counter() - t0
    print(f"[demo] {noise_pred.shape[0]} patches in {seconds:.1f}s", file=sys.stderr)

    # split the ordered stream back into shapes
    counts = dataset.shape_patch_count
    offsets = np.cumsum([0] + list(counts))
    per_shape = []
    for i, name in enumerate(shape_names):
        s = slice(offsets[i], offsets[i + 1])
        per_shape.append({
            "shape": name,
            "gt_sigma": float(gt_sigma[i]),
            "patches": int(counts[i]),
            "mean_noise_pred": float(noise_pred[s].mean()),
            "median_noise_pred": float(np.median(noise_pred[s])),
            "small_branch_frac": float(
                (noise_pred[s] < NOISE_SWITCH_THRESHOLD).mean()
            ),
            "rms_deg": float(np.sqrt(np.mean(ang_err[s] ** 2))),
        })

    # aggregate by GT noise level
    print("\n| GT sigma | mean noise_pred | small-branch share | RMS (deg) |")
    print("|---|---|---|---|")
    by_sigma = {}
    for row in per_shape:
        by_sigma.setdefault(row["gt_sigma"], []).append(row)
    for sigma in sorted(by_sigma):
        rows = by_sigma[sigma]
        mp = np.mean([r["mean_noise_pred"] for r in rows])
        sf = np.mean([r["small_branch_frac"] for r in rows])
        rms = np.sqrt(np.mean([r["rms_deg"] ** 2 for r in rows]))
        print(f"| {sigma:.3f} | {mp:.4f} | {sf:.2%} | {rms:.3f} |")

    sig = np.array([r["gt_sigma"] for r in per_shape])
    prd = np.array([r["mean_noise_pred"] for r in per_shape])
    corr = float(np.corrcoef(sig, prd)[0, 1])
    overall_small = float(np.mean(noise_pred < NOISE_SWITCH_THRESHOLD))
    overall_rms = float(np.sqrt(np.mean(ang_err ** 2)))
    print(f"\nper-shape corr(noise_pred, GT sigma): {corr:.4f}")
    print(f"overall small-branch share: {overall_small:.2%}")
    print(f"overall RMS: {overall_rms:.3f} deg")
    line = {
        "run_dir": args.run_dir,
        "testset": args.testset,
        "n_patches": int(noise_pred.shape[0]),
        "corr_noise_pred_vs_gt": corr,
        "small_branch_share": overall_small,
        "rms_deg": overall_rms,
        "per_sigma": {
            f"{sigma:.3f}": {
                "mean_noise_pred": float(
                    np.mean([r["mean_noise_pred"] for r in by_sigma[sigma]])
                ),
                "small_branch_frac": float(
                    np.mean([r["small_branch_frac"] for r in by_sigma[sigma]])
                ),
                "rms_deg": float(np.sqrt(np.mean(
                    [r["rms_deg"] ** 2 for r in by_sigma[sigma]]
                ))),
            }
            for sigma in sorted(by_sigma)
        },
    }
    print(json.dumps(line), flush=True)
    return line | {
        "patches_per_sigma": {f"{sigma:.3f}": sum(r["patches"] for r in by_sigma[sigma])
                              for sigma in sorted(by_sigma)},
        "seconds": seconds,
    }


if __name__ == "__main__":
    main()
