"""Device-sparse serving throughput of two checkouts of this repository,
measured on one card in one run.

    python nestinet_tpu_torch/scripts/serve_compare.py OTHER_CHECKOUT WORK_DIR

Run it from the root of a checkout (the "change"); OTHER_CHECKOUT is the
root of another one (say `git archive` of the parent, unpacked).  It builds
`chip_smoke.py`'s full-width flagship run dir (random weights and BatchNorm
state from its seed, the manager's last layer spread over the experts) and
its 6-shape synthetic testset once, in WORK_DIR, then serves them
device-sparse at batch 256 in bfloat16, bfloat16 with BN folded, int8 and
int8 with BN folded, with each checkout's own `nestinet_tpu_torch` in a
process of its own, in the order other, change, change, other.  Each path
is warmed up on two shapes first; the 30,000 patches are then timed.

The serving paths are bound by launches and host time, which differ from
one machine to the next by more than most changes move them: compare only
numbers from one run.  The last line is a JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PATHS = (("bf16", "bfloat16", False), ("bf16+fold", "bfloat16", True),
         ("int8", "int8", False), ("int8+fold", "int8", True))


def prepare(work: str) -> None:
    """The run dir and testset of `chip_smoke.py`, built with this checkout."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke
    from nestinet_tpu_torch.core import checkpoint
    from nestinet_tpu_torch.core.config import Config
    from nestinet_tpu_torch.core.rundir import RunDir
    from nestinet_tpu_torch.data.synthetic import build_protocol_benchmark
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.models.base import init_params
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    dev = torch.device("cuda")
    data = os.path.join(work, "data")
    build_protocol_benchmark(data, n_points=smoke.N_POINTS, n_pidx=500,
                             seed=smoke.SEED % 1000)
    with open(os.path.join(data, "testset.txt")) as f:
        shapes = [s.strip() for s in f if s.strip()]
    with open(os.path.join(data, "testset_two.txt"), "w") as f:
        f.write("\n".join(shapes[:2]) + "\n")
    cfg = Config(model="experts_n_est", log_dir=os.path.join(work, "run"), data_path=data,
                 patch_radius=(0.01, 0.03, 0.05), num_point=512, num_gaussians=8,
                 n_experts=smoke.N_EXPERTS, seed=smoke.SEED)
    grids, queries, radii, bseed, caps = smoke.check_extraction(dev, data, shapes[0],
                                                                cfg.patch_radius)
    rd = RunDir.create(cfg.log_dir)
    cfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([8, 8, 8], variance=cfg.gmm_variance)
    gmm.save(rd.gmm_path)
    model = build_model(cfg, gmm)
    gen = torch.Generator().manual_seed(smoke.SEED)
    init_params(model, gen)
    smoke.randomize_bn(model, gen)
    smoke.spread_manager_logits(model.to(dev), grids, queries, radii, bseed, caps)
    checkpoint.save(rd.path, model.cpu().state_dict())


def serve(tree: str, work: str, label: str) -> None:
    """Every path of PATHS with `tree`'s package; prints one RESULT line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import nestinet_tpu_torch
    from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
    from nestinet_tpu_torch.ops.kernels import int8_cuda, mups_cuda
    from nestinet_tpu_torch.ops.kernels.build import build_all

    print(f"{label}: {os.path.dirname(nestinet_tpu_torch.__file__)}", flush=True)
    build_all((mups_cuda.KERNEL, int8_cuda.KERNEL))
    data, run = os.path.join(work, "data"), os.path.join(work, "run")
    rates = {}
    for name, dtype, fold in PATHS:
        kw = dict(data_path=data, batch_size=256, moe_inference="sparse",
                  compute_dtype=dtype, fold_bn=fold)
        predict_shapes_device(run, testset="testset_two.txt",
                              dataset_name=f"warm_{label}_{name}", **kw)
        torch.cuda.synchronize()
        stats = predict_shapes_device(run, testset="testset.txt",
                                      dataset_name=f"timed_{label}_{name}", **kw)
        rates[name] = stats["patches_per_sec"]
        print(f"{label} {name}: {rates[name]:.1f} patches/s", flush=True)
    print("RESULT " + json.dumps(rates), flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("work", help="directory for the run dir, the data and the outputs")
    ap.add_argument("--prepare", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--serve", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.prepare:
        prepare(args.work)
        return {}
    if args.serve:
        serve(args.serve[0], args.work, args.serve[1])
        return {}

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    me = os.path.abspath(__file__)
    subprocess.run([sys.executable, me, args.other, args.work, "--prepare"], check=True)
    runs = []
    for label, tree in (("other", args.other), ("change", "."), ("change", "."),
                        ("other", args.other)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, me, args.other, args.work, "--serve", tree, label],
                             check=True, capture_output=True, text=True).stdout
        print(out, end="", flush=True)
        rates = json.loads(out.rsplit("RESULT ", 1)[1])
        runs.append({"label": label, "seconds": time.perf_counter() - t0, "patches_per_sec": rates})
    summary = {"card": card, "runs": runs, "ratio": {}}
    for name, _, _ in PATHS:
        mean = {lab: sum(r["patches_per_sec"][name] for r in runs if r["label"] == lab) / 2
                for lab in ("other", "change")}
        summary["ratio"][name] = mean["change"] / mean["other"]
        print(f"{name}: other {mean['other']:.1f}, change {mean['change']:.1f} patches/s, "
              f"x{summary['ratio'][name]:.3f} [{card}]", flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
