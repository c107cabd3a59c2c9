"""Inference CLI of the PyTorch port (counterpart of
`nestinet_tpu/cli/test.py`).

Reloads a run directory's config, GMM and torch checkpoint (the best one,
`<run>/ckpt_torch_best/model.pt`, when the trainer wrote it, else
`<run>/ckpt_torch/model.pt`) and writes
`<run>/<dataset>_results/<shape>.normals` (plus `.experts` and
`.experts_probs`) for every shape in the test list, on the GPU.

Example:
    python -m nestinet_tpu_torch.cli.test --results_path=log/my_experts \\
        --dataset_name=pcpnet --testset=testset.txt --batch_size=128 \\
        --extraction=device --moe_inference=sparse

Ported: mixture-of-experts inference in bfloat16 (the default, as in the
JAX CLI), float32 or int8, optionally with BatchNorm folded into the
kernels (`--fold_bn=1`; default: the run config), routed (sparse, the
default) or dense, with host (kd-tree) or device (grid-hash ball query)
patch extraction, on every point or on the `.pidx` subsets
(`--sparse_patches=1`).  Data-parallel serving (`--data_parallel > 1`)
raises: one GPU serves.
"""

from __future__ import annotations

import argparse
import json

from ..infer.device_pipeline import predict_shapes_device
from ..infer.predict import MOE_INFERENCE, predict_shapes
from ..models.base import COMPUTE_DTYPES


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results_path", default="log/my_experts",
                   help="path to the trained run directory")
    p.add_argument("--dataset_name", type=str, default="pcpnet")
    p.add_argument("--dataset_path", type=str, default=None,
                   help="data directory (default: the run config's data_path)")
    p.add_argument("--sparse_patches", type=int, default=0,
                   help="1: serve only each shape's .pidx subset")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--testset", type=str, default="testset.txt")
    p.add_argument("--loader_workers", type=int, default=8)
    p.add_argument("--extraction", type=str, default="host", choices=["host", "device"],
                   help="host: kd-tree patch extraction on CPU threads; device: "
                        "upload each cloud once and extract with the grid-hash "
                        "ball query on the GPU")
    p.add_argument("--moe_inference", type=str, default="sparse", choices=MOE_INFERENCE,
                   help="sparse (default): each patch through its argmax expert "
                        "only; dense: every expert on every patch (same outputs)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=list(COMPUTE_DTYPES),
                   help="CNN compute dtype for serving (parameters stay float32); "
                        "int8 runs the convs and linears on the int8 kernel")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="not ported: only one GPU serves")
    p.add_argument("--fold_bn", type=int, default=None,
                   help="1: fold eval BatchNorm affines into the conv/linear kernels "
                        "at load (ops/fold.py). Default: the run config")
    args = p.parse_args(argv)
    if args.data_parallel > 1:
        raise NotImplementedError(
            f"--data_parallel={args.data_parallel} is not ported to PyTorch yet; "
            "only one GPU (see ROADMAP.md)"
        )

    common = dict(
        dataset_name=args.dataset_name,
        testset=args.testset,
        data_path=args.dataset_path,
        batch_size=args.batch_size,
        sparse_patches=bool(args.sparse_patches),
        moe_inference=args.moe_inference,
        compute_dtype=args.compute_dtype,
        fold_bn=None if args.fold_bn is None else bool(args.fold_bn),
    )
    if args.extraction == "device":
        stats = predict_shapes_device(args.results_path, **common)
    else:
        stats = predict_shapes(args.results_path, loader_workers=args.loader_workers,
                               **common)
    print(json.dumps({k: v for k, v in stats.items() if k != "shapes"}, indent=2))


if __name__ == "__main__":
    main()
