"""Inference CLI of the PyTorch port (counterpart of
`nestinet_tpu/cli/test.py`).

Reloads a run directory's config, GMM and torch checkpoint
(`<run>/ckpt_torch/model.pt`) and writes
`<run>/<dataset>_results/<shape>.normals` (plus `.experts` and
`.experts_probs`) for every shape in the test list, on the GPU.

Example:
    python -m nestinet_tpu_torch.cli.test --results_path=log/my_experts \
        --dataset_name=pcpnet --testset=testset.txt --batch_size=128

Only dense float32 mixture-of-experts inference with host (kd-tree) patch
extraction is ported; the other modes of the JAX CLI raise.
"""

from __future__ import annotations

import argparse
import json

from ..infer.predict import predict_shapes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results_path", default="log/my_experts",
                   help="path to the trained run directory")
    p.add_argument("--dataset_name", type=str, default="pcpnet")
    p.add_argument("--dataset_path", type=str, default=None,
                   help="data directory (default: the run config's data_path)")
    p.add_argument("--testset", type=str, default="testset.txt")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--loader_workers", type=int, default=8)
    p.add_argument("--moe_inference", type=str, default="dense",
                   help="only 'dense' is ported")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="only 'float32' is ported")
    p.add_argument("--extraction", type=str, default="host",
                   help="only 'host' is ported")
    args = p.parse_args(argv)
    for flag, ported in (("moe_inference", "dense"), ("compute_dtype", "float32"),
                         ("extraction", "host")):
        if getattr(args, flag) != ported:
            raise NotImplementedError(
                f"--{flag}={getattr(args, flag)} is not ported to PyTorch yet; "
                f"only --{flag}={ported} (see ROADMAP.md)"
            )

    stats = predict_shapes(
        args.results_path,
        dataset_name=args.dataset_name,
        testset=args.testset,
        data_path=args.dataset_path,
        batch_size=args.batch_size,
        loader_workers=args.loader_workers,
    )
    print(json.dumps({k: v for k, v in stats.items() if k != "shapes"}, indent=2))


if __name__ == "__main__":
    main()
