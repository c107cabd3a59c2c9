"""What the expert-parallel tests run on each rank.

`nestinet_tpu_torch.train.distributed.launch` starts each rank in a new
interpreter and calls a function by its module and name; these live here,
apart from the tests, so that a rank imports torch and the port only, never
JAX.  Each returns what rank 0 hands back to the test.
"""

import torch
import torch.distributed as dist

from nestinet_tpu_torch.models import build_model
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.gmm import GridGMM
from nestinet_tpu_torch.train import mesh as mesh_lib
from nestinet_tpu_torch.train import train_step as tts


class _SummedGather(mesh_lib._GatherExperts):
    """The control: a gather whose backward sums the incoming gradient over
    the expert group, which multiplies each sharded expert's gradient by
    the group's size."""

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank], None, None, None


def _summed_gather(mesh):
    def gather(x):
        return _SummedGather.apply(x, mesh.expert_group, mesh.expert_rank, mesh.expert_size)
    return gather


def ep_case(case: dict) -> dict:
    """`case["steps"]` train steps of the model `case` describes from
    `case["state_dict"]` (the whole model's) on a (data, expert) mesh of
    `cfg.data_parallel` x `cfg.expert_parallel` ranks, each rank on its rows
    of `case["batch"]` and holding its expert shard; with `summed` the
    gather's backward sums over the expert group (the control).  Returns,
    on rank 0, every rank's [per step: loss, state dict, optimizer state by
    parameter name] and its parameter and optimizer-state counts."""
    cfg = case["cfg"]
    mesh = mesh_lib.make_mesh(cfg.data_parallel, cfg.expert_parallel)
    model = build_model(cfg, GridGMM(*case["gmm"]))
    model.load_state_dict(case["state_dict"])
    mesh_lib.shard_model(model, mesh, _summed_gather(mesh) if case.get("summed") else None)
    model.train()
    tnn.set_moment_sum(model, mesh.sum if mesh.size > 1 else None)
    opt = tts.make_optimizer(model, cfg)
    step = tts.make_train_step(model, cfg, opt, mesh=mesh)
    local = mesh_lib.shard_batch(case["batch"], mesh)
    names = [n for n, _ in model.named_parameters()]
    steps = []
    for i in range(case["steps"]):
        loss = step(local, i)
        steps.append({
            "loss": float(loss),
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "moments": {n: {k: v.clone() for k, v in opt.state[p].items()}
                        for n, p in zip(names, model.parameters())},
        })
    mine = {"steps": steps, "coords": (mesh.rank, mesh.expert_rank),
            "n_params": sum(p.numel() for p in model.parameters()),
            "n_moments": sum(v.numel() for s in opt.state.values() for v in s.values()
                             if v.dim() > 0)}
    if not mesh.parallel:
        return [mine]
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(mine, out, dst=0)
    return out


def ep_cases(cases: list) -> list:
    """`ep_case` of each case in turn."""
    return [ep_case(case) for case in cases]


def resume_step(cfg, path: str, batch: dict):
    """Resume the run dir at `path` with the trainer on this rank's mesh
    (`cfg.data_parallel` x `cfg.expert_parallel`), take one train step on
    this rank's rows of `batch`, and return, on rank 0, (loss, step, start
    epoch, state dict, optimizer state) in the one-process layout."""
    from nestinet_tpu_torch.core.rundir import RunDir
    from nestinet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, run_dir=RunDir.open(path), device="cpu")
    trainer.restore()
    step, epoch = trainer.step, trainer.start_epoch
    loss = trainer._train_step(mesh_lib.shard_batch(batch, trainer.mesh), step)
    state = trainer._checkpoint_state()
    trainer.rundir.close()
    if state is None:
        return None
    return float(loss), step, epoch, state[0], state[1]
