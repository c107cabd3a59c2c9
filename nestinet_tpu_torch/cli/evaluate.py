"""Evaluation CLI of the PyTorch port (counterpart of
`nestinet_tpu/cli/evaluate.py`, the same flags; parity:
`utils/evaluate.py:20-29`).  `--expert_statistics 1` also writes the
per-expert error and usage summary
(`images/expert_statistics/<set>_expert_statistics.json`).
`--export_visualizations 1` raises NotImplementedError: its plots need
matplotlib and the JAX package's `viz/` renders, not ported (ROADMAP
queue 1, item 4, the matplotlib renders; `nestinet_tpu_torch/viz/` holds
the NumPy helpers they are drawn from).

Example:
    python -m nestinet_tpu_torch.cli.evaluate \\
        --normal_results_path=log/my_experts/pcpnet_results/ \\
        --data_path=data/pcpnet/ \\
        --dataset_list testset testset_whitenoise_small \\
            testset_whitenoise_medium testset_whitenoise_large \\
            testset_vardensity_gradient testset_vardensity_striped
"""

from __future__ import annotations

import argparse

from ..eval.evaluate import evaluate_datasets
from ..eval.expert_stats import compute_expert_statistics


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--normal_results_path", default="log/my_experts/pcpnet_results/")
    p.add_argument("--data_path", type=str, default="data/pcpnet/")
    p.add_argument("--sparse_patches", type=int, default=1)
    p.add_argument("--dataset_list", type=str, nargs="+", default=["testset"])
    p.add_argument("--export_visualizations", type=int, default=0,
                   help="per-shape (phi,theta) plots + cloud renders (reference "
                        "EXPORT branch, utils/evaluate.py:161-185): not ported, raises")
    p.add_argument("--n_experts", type=int, default=7)
    p.add_argument("--expert_statistics", type=int, default=0,
                   help="also aggregate per-expert error/usage statistics "
                        "(parity: MATLAB/compute_expert_statistics.m)")
    args = p.parse_args(argv)

    evaluate_datasets(
        args.data_path,
        args.normal_results_path,
        args.dataset_list,
        sparse_patches=bool(args.sparse_patches),
        export=bool(args.export_visualizations),
        n_experts=args.n_experts,
    )
    if args.expert_statistics:
        for d in args.dataset_list:
            compute_expert_statistics(
                args.data_path, args.normal_results_path, d,
                n_experts=args.n_experts, export_plots=False,
            )


if __name__ == "__main__":
    main()
