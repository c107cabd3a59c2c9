"""Inference CLI of the PyTorch port (counterpart of
`nestinet_tpu/cli/test.py`).

Reloads a run directory's config, GMM and checkpoint (the best one,
`<run>/ckpt_torch_best/model.pt`, when the trainer wrote it, else
`<run>/ckpt_torch/model.pt`; in a run dir that only the JAX trainer wrote,
its `ckpt_best/` or `ckpt/` msgpack) and writes
`<run>/<dataset>_results/<shape>.normals` (plus `.experts` and
`.experts_probs` for the mixture of experts, and `.experts`, the branch,
and `.noise` for the switching model served routed) for every shape in the
test list, on the GPU.  The model is the run config's: `experts_n_est`,
`ss_norm_est`, `ms_norm_est` or `ms_sw_n_est` (`--model` names the one
the run must hold).

Example:
    python -m nestinet_tpu_torch.cli.test --results_path=log/my_experts \\
        --dataset_name=pcpnet --testset=testset.txt --batch_size=128 \\
        --extraction=device --moe_inference=sparse

Ported: inference in bfloat16 (the default, as in the JAX CLI), float32 or
int8, optionally with BatchNorm folded into the kernels (`--fold_bn=1`;
default: the run config), the mixture of experts and the switching model
routed (sparse, the default: each patch through its argmax expert or its
branch only) or dense, and the other models dense (`--moe_inference` is
then ignored), with host (kd-tree) or device (grid-hash ball query) patch
extraction, on every point or on the `.pidx` subsets
(`--sparse_patches=1`).  `--data_parallel N` serves on N ranks (one a
GPU; `--device cpu` runs them on the CPU over gloo, `--backend gloo` lets
CUDA ranks share one GPU): each rank serves whole batches, round-robin,
and rank 0 writes the files, which equal one process's.  The batch size
must divide by N, as in JAX.
"""

from __future__ import annotations

import argparse
import json

from ..core.config import Config
from ..core.rundir import RunDir
from ..infer.device_pipeline import predict_shapes_device
from ..infer.predict import MOE_INFERENCE, predict_shapes
from ..models.base import COMPUTE_DTYPES
from ..train import distributed

MODEL_CHOICES = ("ss_norm_est", "ms_norm_est", "ms_sw_n_est", "experts_n_est")


def main(argv=None, timeout: float | None = None):
    """Serve as the flags say; returns the stats it prints.  `timeout`:
    seconds after which the data-parallel ranks are killed
    (`distributed.launch`); None waits."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results_path", default="log/my_experts",
                   help="path to the trained run directory")
    p.add_argument("--model", default=None, choices=MODEL_CHOICES,
                   help="the model the run dir must hold (default: its config's)")
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
                   help="sparse (default): each patch through its argmax expert, or "
                        "the switching model's branch, only; dense: every expert or "
                        "branch on every patch (same normals)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=list(COMPUTE_DTYPES),
                   help="CNN compute dtype for serving (parameters stay float32); "
                        "int8 runs the convs and linears on the int8 kernel")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="ranks (one a GPU) that serve whole batches; 0 = one")
    p.add_argument("--backend", type=str, default=None, choices=list(distributed.BACKENDS),
                   help="the data-parallel backend: nccl on CUDA and gloo on the CPU by "
                        "default; gloo on CUDA lets ranks share one GPU (smoke tests)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) raises without a GPU; cpu only when asked")
    p.add_argument("--fold_bn", type=int, default=None,
                   help="1: fold eval BatchNorm affines into the conv/linear kernels "
                        "at load (ops/fold.py). Default: the run config")
    args = p.parse_args(argv)
    if args.model is not None:
        run_model = Config.load(RunDir.open(args.results_path).config_path).model
        if run_model != args.model:
            raise ValueError(f"--model {args.model}: the run dir holds {run_model}")
    data_parallel = max(args.data_parallel, 0) or 1
    if args.batch_size % data_parallel:
        raise ValueError(f"--batch_size {args.batch_size} must divide by --data_parallel "
                         f"{data_parallel}")

    common = dict(
        dataset_name=args.dataset_name,
        testset=args.testset,
        data_path=args.dataset_path,
        batch_size=args.batch_size,
        sparse_patches=bool(args.sparse_patches),
        moe_inference=args.moe_inference,
        compute_dtype=args.compute_dtype,
        fold_bn=None if args.fold_bn is None else bool(args.fold_bn),
        data_parallel=data_parallel,
        device=args.device,
    )
    if args.extraction == "device":
        fn = predict_shapes_device
    else:
        fn = predict_shapes
        common["loader_workers"] = args.loader_workers
    stats = distributed.launch(fn, data_parallel, (args.results_path,), common,
                               device=args.device, backend=args.backend, timeout=timeout)
    print(json.dumps({k: v for k, v in stats.items() if k != "shapes"}, indent=2))
    return stats


if __name__ == "__main__":
    main()
