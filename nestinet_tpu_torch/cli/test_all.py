"""Batch inference of the PyTorch port over a list of test sets
(counterpart of `nestinet_tpu/cli/test_all.py`, plus `--device`; parity:
`utils/nyu_test_all.py`, which shelled out to the test script per NYU-v2
scene; here it is an in-process loop).  Every point of every shape is
served (`sparse_patches=False`), with host (kd-tree) extraction, argmax
routing and the run's dtype.

Example:
    python -m nestinet_tpu_torch.cli.test_all \\
        --results_path=log/my_experts_kinect \\
        --dataset_path=/data/nyu_v2_txt/ \\
        --testset_list=testset_file_list.txt
"""

from __future__ import annotations

import argparse
import os

from ..infer.predict import predict_shapes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results_path", default="log/my_experts_kinect")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--testset_list", type=str, required=True,
                   help="file listing per-scene testset files")
    p.add_argument("--dataset_name", type=str, default="")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--loader_workers", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) raises without a GPU; cpu only when asked")
    args = p.parse_args(argv)

    list_path = os.path.join(args.dataset_path, args.testset_list)
    with open(list_path) as f:
        testsets = [os.path.basename(x.strip()) for x in f.readlines() if x.strip()]

    for testset in testsets:
        print(f"== {testset} ==", flush=True)
        predict_shapes(
            args.results_path,
            dataset_name=args.dataset_name,
            testset=testset,
            data_path=args.dataset_path,
            batch_size=args.batch_size,
            sparse_patches=False,
            loader_workers=args.loader_workers,
            device=args.device,
        )


if __name__ == "__main__":
    main()
