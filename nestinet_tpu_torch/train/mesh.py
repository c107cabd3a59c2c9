"""The data mesh: a process group over the data axis, and its collectives.

Counterpart of `nestinet_tpu/train/mesh.py`.  JAX builds a 2-D device mesh
("data", "expert"), shards the batch over "data" and lets XLA's SPMD
partitioner insert the collectives.  Here a mesh is the data process group
of `torch.distributed` (one rank a GPU, `train/distributed.py`), and the
collectives are explicit:
  * `shard_batch` keeps this rank's rows of a global batch: contiguous, in
    rank order (`distributed.host_batch_slice`), as `NamedSharding(
    P("data"))` lays them out;
  * `DataMesh.mean_gradients_` averages the gradients (and the step's
    scalars) over the ranks after the backward pass, in one flat all-reduce;
  * `DataMesh.sum` is an all-reduce sum that autograd differentiates
    (its backward sums the incoming gradients over the ranks), for
    BatchNorm's global training moments (`ops/nn.py::BatchNormEMA`);
  * gathers and a broadcast of Python objects, to rank 0 or to all.

The parameters are replicated on every rank, so JAX's sharding trees
(`param_shardings`, `moe_param_shardings`, `opt_state_shardings`) have no
counterpart: every rank holds the whole model and optimizer state and
applies the same averaged update.  Expert parallelism (the "expert" axis)
is not ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import distributed

DATA_AXIS = "data"
EXPERT_AXIS = "expert"


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient of each rank's input is the
    sum of the gradients that every rank's output received."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's place on the data axis.  `group` is None in a process
    that is no rank of a group (one process, no collectives)."""

    group: object
    rank: int
    size: int

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def parallel(self) -> bool:
        """True when the collectives run (a group, a world of one included)."""
        return self.group is not None

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (`host_batch_slice`)."""
        if global_batch % self.size:
            raise ValueError(f"global batch {global_batch} must divide by the data "
                             f"axis of {self.size}")
        per = global_batch // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The autograd-aware all-reduce sum."""
        return _AllReduceSum.apply(tensor, self.group)

    def mean_gradients_(self, params, scalars: dict) -> dict:
        """Average every `.grad` of `params` over the ranks in place, and the
        0-d tensors of `scalars` with them, in one flat all-reduce; returns
        the averaged scalars."""
        grads = [p.grad for p in params if p.grad is not None]
        names = list(scalars)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [torch.stack([scalars[k].float() for k in names])])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return {k: flat[offset + i] for i, k in enumerate(names)}

    def all_reduce_sum_(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks (no autograd); the tensor itself
        outside a group."""
        if self.parallel:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def gather_to_main(self, obj) -> list | None:
        """[every rank's `obj`] on rank 0, in rank order; None elsewhere."""
        if not self.parallel:
            return [obj]
        out = [None] * self.size if self.is_main else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def all_gather(self, obj) -> list:
        """[every rank's `obj`] on every rank, in rank order."""
        if not self.parallel:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, obj):
        """Rank 0's `obj` on every rank."""
        if not self.parallel:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def check_expert_parallel(expert_parallel: int) -> None:
    """Expert parallelism is not ported: raise for expert_parallel > 1."""
    if expert_parallel > 1:
        raise NotImplementedError(
            f"expert_parallel={expert_parallel}: expert parallelism is not ported to "
            "PyTorch (ROADMAP.md queue 1, item 5); the parameters are replicated on "
            "every data rank")


def make_mesh(data_parallel: int = 0, expert_parallel: int = 1) -> DataMesh:
    """The data mesh of this process.  data_parallel=0 means "every rank
    of the world".  In a process group the data axis is the world group
    and must hold `data_parallel` ranks; outside one only
    data_parallel <= 1 is possible (`distributed.launch` starts ranks)."""
    check_expert_parallel(expert_parallel)
    rank, world = distributed.process_info()
    if data_parallel <= 0:
        data_parallel = world
    if data_parallel != world:
        raise ValueError(
            f"data_parallel={data_parallel} needs a process group of that many ranks; "
            f"this process is in a world of {world} (start the ranks with "
            "train.distributed.launch)")
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return DataMesh(group, rank, world)


def shard_batch(batch: dict, mesh: DataMesh) -> dict:
    """This rank's rows of a global batch."""
    rows = mesh.rows(next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}
