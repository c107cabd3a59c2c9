"""Synthetic PCPNet-protocol data set CLI of the PyTorch port
(counterpart of `nestinet_tpu/cli/synth.py`: the same flags and files,
through the port's `data/synthetic.py`).

Materializes an analytic-surface dataset with the exact PCPNet list
layout (train/validation lists plus the six canonical testsets,
the reference's `utils/evaluate.py:40-41`) so the full
train -> test -> evaluate pipeline runs end to end without the real
PCPNet download.

Example:
    python -m nestinet_tpu_torch.cli.synth --root data/synth_pcpnet \\
        --n_points 50000 --n_pidx 5000
"""

from __future__ import annotations

import argparse

from ..data.synthetic import build_protocol_benchmark, build_switching_benchmark


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default="data/synth_pcpnet")
    p.add_argument("--n_points", type=int, default=50_000)
    p.add_argument("--n_pidx", type=int, default=5_000)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument(
        "--switching", action="store_true",
        help="build the noise-switching regime instead (sigmas straddle "
             "the 0.015 hard-switch threshold; see data/synthetic.py)",
    )
    args = p.parse_args(argv)
    build = build_switching_benchmark if args.switching else build_protocol_benchmark
    sets = build(
        args.root, n_points=args.n_points, n_pidx=args.n_pidx, seed=args.seed
    )
    for name, shapes in sets.items():
        print(f"{name}: {len(shapes)} shapes")


if __name__ == "__main__":
    main()
