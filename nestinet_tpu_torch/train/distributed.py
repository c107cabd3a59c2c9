"""Multi-process initialization, data splitting and the rank launcher.

Counterpart of `nestinet_tpu/train/distributed.py`.  JAX runs one SPMD
program per host over a global device mesh; PyTorch runs one process (a
rank) per GPU in a `torch.distributed` process group.  NCCL serves CUDA
tensors and gloo serves the CPU.

How ranks map to hosts and GPUs.  `--data_parallel N` and
`--expert_parallel M` keep JAX's meaning: N data shards and M expert
shards, here a world of N x M ranks (`train/mesh.py`: world rank r sits at
data rank r // M and expert rank r % M).  JAX's variables keep theirs: a
process of JAX is one launcher on one host.

  * `COORDINATOR_ADDRESS` (host:port of host 0), `NUM_PROCESSES` (the
    hosts, H) and `PROCESS_ID` (this host, h) are read by `initialize()`
    and by `launch()`, as by `jax.distributed.initialize`;
  * `launch()` on host h starts N x M / H local ranks, local rank l drives
    `cuda:l` (or the CPU when the caller asks for it), and its global
    rank is h * (N x M / H) + l; all ranks meet at `tcp://COORDINATOR_ADDRESS`
    (on one host: a free localhost port);
  * a process started by some other launcher, one per GPU, calls
    `initialize()` with its own rank as PROCESS_ID and the world size as
    NUM_PROCESSES (one rank a process, `local_size=1`).

The backend is NCCL for CUDA and gloo for the CPU.  Only an explicit
`backend="gloo"` puts CUDA tensors on gloo; it lets several ranks share
one GPU, which NCCL refuses.  NCCL with more local ranks than visible GPUs
raises; nothing falls back to gloo or to the CPU.

Typical use:

    from nestinet_tpu_torch.train import distributed
    distributed.launch(fn, 4, args, device="cuda")   # fn runs on 4 ranks
    # inside fn, as in JAX:
    shard = distributed.host_shard(range(n_shapes))    # this rank's items
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# how long a rank waits in the rendezvous and in a collective
GROUP_TIMEOUT_S = 600


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device: str | torch.device = "cuda", local_rank: int = 0,
               local_size: int = 1) -> None:
    """`torch.distributed.init_process_group` with JAX's environment
    fallbacks (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); a no-op
    for a world of one, so call sites can be unconditional.  Each of the
    `num_processes` processes holds `local_size` ranks (`launch()` starts
    them); this one is local rank `local_rank`."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("NUM_PROCESSES", "1"))
    world = num * local_size
    if world <= 1:
        return
    pid = process_id if process_id is not None else int(os.environ.get("PROCESS_ID", "0"))
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not address:
        raise ValueError("a multi-process run needs COORDINATOR_ADDRESS (host:port)")
    init_group(pid * local_size + local_rank, world, address,
               resolve_backend(device, backend))


def init_group(rank: int, world_size: int, address: str, backend: str) -> None:
    """Join the world group at `tcp://address` as `rank` of `world_size`,
    a world of one included."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def resolve_backend(device, backend: str | None = None) -> str:
    """NCCL for a CUDA device and gloo for the CPU, unless `backend` names
    one; NCCL on the CPU raises."""
    kind = torch.device(device).type
    if backend is None:
        return "nccl" if kind == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("NCCL serves CUDA tensors only; the CPU takes gloo")
    return backend


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_rank_info(expert_parallel: int = 1) -> tuple[int, int]:
    """(data rank, data ranks) of this rank on a (data, expert) mesh with
    `expert_parallel` ranks on the expert axis (`train/mesh.py::make_mesh`:
    world rank r sits at data rank r // expert_parallel)."""
    idx, count = process_info()
    return idx // expert_parallel, count // expert_parallel


def host_shard(items, expert_parallel: int = 1) -> list:
    """This rank's slice of a global work list (shapes, files, ...):
    round-robin by data rank, so every data rank gets distinct items and
    the ranks of one expert group the same ones."""
    idx, count = data_rank_info(expert_parallel)
    return [it for i, it in enumerate(items) if i % count == idx]


def host_batch_slice(global_batch: int, expert_parallel: int = 1) -> slice:
    """The rows of a global batch that this rank holds: contiguous, in data
    rank order, as JAX's `NamedSharding(P("data"))` lays a batch out; the
    ranks of one expert group hold the same rows."""
    idx, count = data_rank_info(expert_parallel)
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} must divide by process count {count}"
        )
    per = global_batch // count
    return slice(idx * per, (idx + 1) * per)


# ---------------------------------------------------------------- launcher


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, local_rank: int, backend: str) -> torch.device:
    """The device of local rank `local_rank`: `cuda:<local rank>` (under an
    explicit gloo, ranks past the visible GPUs share them round-robin) or
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if dev.index is not None:
        return dev
    count = torch.cuda.device_count()
    return torch.device("cuda", local_rank % count if backend == "gloo" else local_rank)


def prebuild(device) -> None:
    """Build the native libraries the ranks load (the host sampler and text
    writer; on CUDA also the kernels) once, before the ranks start, so that
    no two ranks compile the same library at once."""
    from ..core import textio
    from ..data import native

    native.get_library()
    textio.get_library()
    if torch.device(device).type == "cuda":
        from ..ops.kernels import int8_cuda, mups_cuda, pool_cuda
        from ..ops.kernels.build import build_all

        build_all((mups_cuda.KERNEL, *int8_cuda.KERNELS, *pool_cuda.KERNELS))


def _die_with_parent() -> None:
    """Linux: have the kernel kill this process when its parent dies, so
    that no rank outlives a launcher that was killed."""
    try:
        import ctypes
        import signal

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank_main(local_rank: int, fn, args, kwargs, spec: dict) -> None:
    """Entry of a spawned rank: join the group, pin the device and the
    threads, run `fn`, and let global rank 0 save its result."""
    _die_with_parent()
    torch.set_num_threads(spec["threads"])
    dev = rank_device(spec["device"], local_rank, spec["backend"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize(spec["address"], spec["num_processes"], spec["process_id"],
               backend=spec["backend"], device=dev, local_rank=local_rank,
               local_size=spec["local_size"])
    try:
        out = fn(*args, **kwargs)
        if dist.get_rank() == 0:
            torch.save(out, spec["result"])
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, data_parallel: int, args: tuple = (), kwargs: dict | None = None, *,
           expert_parallel: int = 1, device: str | torch.device = "cuda",
           backend: str | None = None, timeout: float | None = None):
    """Run `fn(*args, **kwargs)` on data_parallel x expert_parallel ranks
    (the global count, over NUM_PROCESSES hosts) and return global rank 0's
    result.

    Inside a process group already, or for one rank on one host, `fn` runs
    in this process.  Otherwise this host's ranks are spawned (`torch.
    multiprocessing`, a new interpreter each) on a free localhost port, or
    at COORDINATOR_ADDRESS across hosts; each runs on `rank_device`, with
    `device="cpu"` only when asked.  `fn` must be importable by name.  With
    `timeout` (seconds), ranks still running then are killed and
    TimeoutError raised; a rank that fails kills the others and re-raises.
    """
    kwargs = kwargs or {}
    ranks = data_parallel * expert_parallel
    if (dist.is_available() and dist.is_initialized()) or (
            ranks == 1 and int(os.environ.get("NUM_PROCESSES", "1")) == 1):
        return fn(*args, **kwargs)
    backend = resolve_backend(device, backend)
    hosts = int(os.environ.get("NUM_PROCESSES", "1"))
    if data_parallel < 1 or expert_parallel < 1 or ranks % hosts:
        raise ValueError(f"data_parallel={data_parallel} x expert_parallel={expert_parallel} "
                         f"must be a positive multiple of the {hosts} processes (hosts)")
    local = ranks // hosts
    if backend == "nccl":
        visible = torch.cuda.device_count()
        if local > visible:
            raise ValueError(
                f"NCCL needs one GPU a rank: {local} local ranks but {visible} visible "
                "GPUs; pass backend='gloo' explicitly to share GPUs between ranks")
    if hosts > 1:
        address = os.environ["COORDINATOR_ADDRESS"]
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    else:
        address, process_id = f"127.0.0.1:{free_port()}", 0
    prebuild(device)

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="nestinet_dp_") as scratch:
        spec = dict(address=address, num_processes=hosts, process_id=process_id,
                    local_size=local, backend=backend, device=str(device),
                    threads=max(1, torch.get_num_threads() // local),
                    result=os.path.join(scratch, "rank0.pt"))
        ctx = mp.start_processes(_rank_main, args=(fn, args, kwargs, spec), nprocs=local,
                                 join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{local} ranks did not finish within {timeout} s; "
                                   "every rank was killed")
        if process_id != 0:
            return None
        return torch.load(spec["result"], weights_only=False)
