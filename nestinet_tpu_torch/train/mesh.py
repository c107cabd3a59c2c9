"""The (data, expert) mesh: process groups over the two axes, their
collectives, and which experts each expert rank holds.

Counterpart of `nestinet_tpu/train/mesh.py`.  JAX builds a 2-D device mesh
("data", "expert") from `devices[:dp * ep].reshape(dp, ep)`, shards the
batch over "data", shards each mixture-of-experts group stack whose size
divides by ep over "expert" (`moe_param_shardings`) and lets XLA's SPMD
partitioner insert the collectives.  Here a rank is one process of
`torch.distributed` (one a GPU, `train/distributed.py`), world rank
r = d * ep + e sits at (data d, expert e), and the collectives are
explicit:
  * the data group (the ranks sharing e) holds the rows of a global batch,
    contiguous in data-rank order (`shard_batch`, as `NamedSharding(
    P("data"))` lays them out); every rank of an expert group holds the
    same rows, as JAX replicates the batch over "expert";
  * `Mesh.sum` is the data group's all-reduce sum that autograd
    differentiates, for BatchNorm's global training moments
    (`ops/nn.py::BatchNormEMA`);
  * `Mesh.mean_gradients_` averages the gradients and the step's scalars
    after the backward pass: an expert shard's over its data group, a
    replicated parameter's over the world;
  * `Mesh.gather_experts` gathers the expert shards' outputs over the
    expert group, its backward keeping this rank's slice;
  * gathers and a broadcast of Python objects.

`held_experts` is `moe_param_shardings`' rule: a group of G experts with
G % ep == 0 is split into ep contiguous blocks of G / ep and block e goes
to expert rank e; every other group, and every model that is not a
mixture of experts, is replicated on every rank.  A model's optimizer
state follows its parameters (`opt_state_shardings`), since the
optimizer is built on the rank's own parameters.
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


class _GatherExperts(torch.autograd.Function):
    """[size, *x.shape]: every rank's `x` in expert-rank order, gathered as a
    sum of zeros but one slot (an all-reduce, which gloo serves on CUDA
    tensors as well).  Every rank of an expert group computes the same loss
    from the gathered tensor, so the gradient of this rank's `x` is its own
    slice of the incoming gradient, not a sum over the group."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank = group, rank
        out = x.new_zeros((size, *x.shape))
        out[rank] = x
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank], None, None, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, expert) mesh.  `group` is the data
    group, `rank` and `size` this rank's data rank and the data axis (dp);
    `expert_group`, `expert_rank` and `expert_size` the same on the expert
    axis (None, 0 and 1 without expert parallelism).  `group` is None in a
    process that is no rank of a group (one process, no collectives)."""

    group: object
    rank: int
    size: int
    expert_group: object = None
    expert_rank: int = 0
    expert_size: int = 1

    @property
    def is_main(self) -> bool:
        """World rank 0: the rank that writes the run dir."""
        return self.rank == 0 and self.expert_rank == 0

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
        """The data group's autograd-aware all-reduce sum."""
        return _AllReduceSum.apply(tensor, self.group)

    def gather_experts(self, x: torch.Tensor) -> torch.Tensor:
        """[expert_size, *x.shape]: the expert group's `x`, autograd-aware."""
        return _GatherExperts.apply(x, self.expert_group, self.expert_rank, self.expert_size)

    def expert_sum_(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over the expert group (no autograd)."""
        if self.expert_size > 1:
            dist.all_reduce(tensor, group=self.expert_group)
        return tensor

    def mean_gradients_(self, params, scalars: dict, sharded=()) -> dict:
        """Average every `.grad` of `params` over the ranks in place, and the
        0-d tensors of `scalars` with them; returns the averaged scalars.
        Without expert parallelism: one flat all-reduce over the data group.
        With it, the gradients of `sharded` (this rank's expert shard) and
        the scalars, the same on every rank of an expert group, are averaged
        over the data group, and every other gradient over the world, which
        keeps the replicas equal even where a backward pass is not
        deterministic."""
        params = [p for p in params if p.grad is not None]
        names = list(scalars)
        values = [torch.stack([scalars[k].float() for k in names])]
        if self.expert_size == 1:
            out = _mean_([p.grad for p in params] + values, self.group, self.size)
            return dict(zip(names, out[-1]))
        mine = {id(p) for p in sharded}
        out = _mean_([p.grad for p in params if id(p) in mine] + values,
                     self.group if self.size > 1 else None, self.size)
        _mean_([p.grad for p in params if id(p) not in mine], dist.group.WORLD,
               self.size * self.expert_size)
        return dict(zip(names, out[-1]))

    def all_reduce_sum_(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over the data group (no autograd); the tensor itself
        outside a group."""
        if self.parallel:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def gather_to_main(self, obj) -> list | None:
        """[every data rank's `obj`] on data rank 0, in rank order; None
        elsewhere."""
        if not self.parallel:
            return [obj]
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=self.expert_rank, group=self.group)
        return out

    def gather_experts_to_main(self, obj) -> list | None:
        """[every expert rank's `obj`] on expert rank 0 of this expert group,
        in rank order; None elsewhere."""
        if self.expert_size == 1:
            return [obj]
        out = [None] * self.expert_size if self.expert_rank == 0 else None
        dist.gather_object(obj, out, dst=self.rank * self.expert_size,
                           group=self.expert_group)
        return out

    def all_gather(self, obj) -> list:
        """[every data rank's `obj`] on every rank, in data-rank order."""
        if not self.parallel:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, obj):
        """World rank 0's `obj` on every rank."""
        if not self.parallel:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def _mean_(tensors: list, group, count: int) -> list:
    """Divide `tensors` in place by `count` after summing them over `group`
    (None: this rank alone) in one flat all-reduce; returns them."""
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if group is not None:
        dist.all_reduce(flat, group=group)
    flat /= count
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def make_mesh(data_parallel: int = 0, expert_parallel: int = 1) -> Mesh:
    """The (data, expert) mesh of this process.  data_parallel=0 means
    world // expert_parallel.  The world must hold exactly data_parallel x
    expert_parallel ranks (`distributed.launch` starts them); world rank
    r sits at (r // ep, r % ep), as JAX's `devices.reshape(dp, ep)`.  Every
    rank builds every group, in the same order (`dist.new_group`)."""
    rank, world = distributed.process_info()
    ep = max(int(expert_parallel), 1)
    dp = data_parallel if data_parallel > 0 else world // ep
    if dp * ep != world:
        raise ValueError(
            f"data_parallel={dp} x expert_parallel={ep} needs a process group of "
            f"{dp * ep} ranks; this process is in a world of {world} (start the ranks "
            "with train.distributed.launch)")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None, 0, 1)
    if ep == 1:
        return Mesh(dist.group.WORLD, rank, world)
    data_groups = [dist.new_group([d * ep + e for d in range(dp)]) for e in range(ep)]
    expert_groups = [dist.new_group([d * ep + e for e in range(ep)]) for d in range(dp)]
    d, e = divmod(rank, ep)
    return Mesh(data_groups[e], d, dp, expert_groups[d], e, ep)


def sharded_groups(group_sizes, expert_parallel: int) -> list[bool]:
    """Which expert groups `moe_param_shardings` shards over the expert
    axis: those whose size divides by expert_parallel > 1."""
    return [expert_parallel > 1 and size % expert_parallel == 0 for size in group_sizes]


def held_experts(groups, expert_rank: int, expert_parallel: int) -> list[int]:
    """The expert ids that expert rank `expert_rank` holds, in reference
    order, given `groups` (each group's expert ids, in the reference's group
    order): block `expert_rank` of each sharded group, every member of the
    others."""
    held = []
    for ids, sharded in zip(groups, sharded_groups([len(g) for g in groups],
                                                   expert_parallel)):
        if sharded:
            per = len(ids) // expert_parallel
            ids = ids[expert_rank * per:(expert_rank + 1) * per]
        held += list(ids)
    return sorted(held)


def shard_model(model, mesh: Mesh, gather=None) -> None:
    """Keep only this rank's experts of a mixture of experts on an expert
    axis of more than one rank, whose forward then gathers the others'
    outputs with `gather` (default `mesh.gather_experts`).  A model without
    expert groups, or with none that divides, stays whole (replicated)."""
    groups = [g.indices for g in getattr(model, "groups", ())]
    if mesh.expert_size == 1 or not any(sharded_groups([len(g) for g in groups],
                                                       mesh.expert_size)):
        return
    blocks = [held_experts(groups, e, mesh.expert_size) for e in range(mesh.expert_size)]
    model.shard_experts(blocks, mesh.expert_rank, gather or mesh.gather_experts)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch."""
    rows = mesh.rows(next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}
