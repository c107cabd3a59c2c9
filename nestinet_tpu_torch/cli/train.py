"""Training CLI of the PyTorch port (counterpart of
`nestinet_tpu/cli/train.py`): the same flags and defaults, plus `--device`.

Trains `--model` (the mixture of experts `experts_n_est`, the default, or
the ablations `ss_norm_est`, `ms_norm_est` and `ms_sw_n_est`; the last reads
per-shape noise levels, `<list>_noise_levels.txt`, as its `noise` target)
on one GPU, in float32 (the default, as in JAX) or bfloat16, into a run
directory that `nestinet_tpu_torch.cli.test` serves: the
periodic checkpoint `ckpt_torch/` (every `--checkpoint_every` epochs and
the last), the best-validation checkpoint `ckpt_torch_best/`, which
serving prefers, `metrics.jsonl` and `log_train.txt`.  `--resume 1` (the
default) continues an existing run dir in place from its periodic
checkpoint, the port's or, in a run dir the JAX trainer wrote, JAX's
`ckpt/`.  `--data_parallel`/`--expert_parallel` > 1 and
`--profile_epoch` raise: they are not ported yet.  `--mups_impl` is kept
for the run config and ignored: the MuPS CUDA kernel runs on the card.

Example (the reference's canonical flagship config):
    python -m nestinet_tpu_torch.cli.train --model=experts_n_est \\
        --n_experts=7 --expert_loss_type=simple \\
        --log_dir=log/my_experts --patch_radius 0.01 0.03 0.05 \\
        --loss_type=sin --batch_size=64 --num_point=512 \\
        --num_gaussians=8 --gmm_variance=0.0156 --learning_rate=0.0001 \\
        --max_epoch=1000 --decay_rate=0.7 --decay_step=491520 \\
        --trainset=trainingset_whitenoise.txt --testset=validationset.txt
"""

from __future__ import annotations

import argparse
import json

from ..core import checkpoint as ckpt_lib
from ..core.config import Config
from ..core.rundir import RunDir
from ..train.trainer import Trainer
from .test import MODEL_CHOICES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="experts_n_est", choices=MODEL_CHOICES)
    p.add_argument("--desc", type=str, default="nestinet_tpu training run")
    p.add_argument("--data_path", type=str, default="data/pcpnet/")
    p.add_argument("--log_dir", default="log/my_experts")
    p.add_argument("--num_point", type=int, default=512)
    p.add_argument("--max_epoch", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=0.0001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--decay_step", type=int, default=8 * 1024 * 15)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--identical_epochs", type=int, default=0)
    p.add_argument("--loss_type", type=str, default="sin",
                   choices=["cos", "euclidean", "sin"])
    p.add_argument("--outputs", type=str, nargs="+", default=["unoriented_normals"])
    p.add_argument("--patch_radius", type=float, nargs="+", default=[0.005, 0.01, 0.03])
    p.add_argument("--patches_per_shape", type=int, default=1024)
    p.add_argument("--trainset", type=str, default="trainingset_whitenoise.txt")
    p.add_argument("--testset", type=str, default="validationset.txt")
    p.add_argument("--insert_rotation_augmentation", type=int, default=0)
    p.add_argument("--num_gaussians", type=int, default=8)
    p.add_argument("--gmm_variance", type=float, default=0.0156)
    p.add_argument("--n_experts", type=int, default=7)
    p.add_argument("--expert_loss_type", type=str, default="simple",
                   choices=["simple", "gaussian"])
    p.add_argument("--expert_dict", type=str,
                   default='{"0": "[0]", "1": "[0]", "2": "[1]", "3": "[1]", '
                           '"4": "[2]", "5": "[2]", "6": "[0, 1, 2]"}')
    p.add_argument("--seed", type=int, default=3627473)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="GPUs on the data axis (0 = one); > 1 is not ported")
    p.add_argument("--expert_parallel", type=int, default=1,
                   help="> 1 is not ported")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--loader_workers", type=int, default=8)
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--resume", type=int, default=1)
    p.add_argument("--profile_epoch", type=int, default=-1,
                   help="-1 (the default); the device trace is not ported")
    p.add_argument("--mups_impl", type=str, default="auto",
                   choices=["auto", "jnp", "pallas"],
                   help="kept in the run config for the JAX package; ignored here")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) raises without a GPU; cpu only when asked")
    return p


def config_from_args(args) -> Config:
    expert_dict = json.loads(args.expert_dict)
    expert_dict = {int(k): json.loads(v) if isinstance(v, str) else v
                   for k, v in expert_dict.items()}
    return Config(
        model=args.model,
        desc=args.desc,
        data_path=args.data_path,
        log_dir=args.log_dir,
        num_point=args.num_point,
        max_epoch=args.max_epoch,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        momentum=args.momentum,
        optimizer=args.optimizer,
        decay_step=args.decay_step,
        decay_rate=args.decay_rate,
        weight_decay=args.weight_decay,
        identical_epochs=bool(args.identical_epochs),
        loss_type=args.loss_type,
        outputs=tuple(args.outputs),
        patch_radius=tuple(args.patch_radius),
        patches_per_shape=args.patches_per_shape,
        trainset=args.trainset,
        testset=args.testset,
        insert_rotation_augmentation=bool(args.insert_rotation_augmentation),
        num_gaussians=args.num_gaussians,
        gmm_variance=args.gmm_variance,
        n_experts=args.n_experts,
        expert_loss_type=args.expert_loss_type,
        expert_dict=expert_dict,
        seed=args.seed,
        data_parallel=max(args.data_parallel, 0) or 1,
        expert_parallel=args.expert_parallel,
        compute_dtype=args.compute_dtype,
        checkpoint_every=args.checkpoint_every,
        profile_epoch=args.profile_epoch,
        mups_impl=args.mups_impl,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.model == "ms_sw_n_est" and "noise" not in cfg.outputs:
        cfg.outputs = tuple(cfg.outputs) + ("noise",)  # JAX `cli/train.py:131-132`
    # --resume must re-open an existing run dir: RunDir.create numbers a
    # fresh sibling on collision (log_dir/1, /2, ...) and would start a new
    # run next to the checkpoint it was asked to resume.  Re-open iff the
    # target dir already holds a periodic checkpoint (the port's or JAX's).
    run_dir = None
    if args.resume and ckpt_lib.resumable(args.log_dir):
        run_dir = RunDir.open(args.log_dir)
    trainer = Trainer(cfg, run_dir=run_dir, loader_workers=args.loader_workers,
                      device=args.device)
    trainer.fit(resume=bool(args.resume))


if __name__ == "__main__":
    main()
