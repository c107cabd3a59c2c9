"""Streaming whole-shape inference, in float32, bfloat16 or int8,
optionally with BatchNorm folded: the mixture of experts and the
noise-switching model routed or dense, the single-scale and multi-scale
models dense.

Counterpart of `nestinet_tpu/infer/predict.py` (`load_run:89`,
`restore_model:154`, `predict_shapes:239`, `SparseMoeRouter:423`,
`_pad_batch:876`): reload a run directory's config, GMM and torch
checkpoint, walk every point of every test shape in order (or only each
shape's `.pidx` subset, with `sparse_patches`) with the JAX package's own
host (kd-tree) loader, zero-pad the last partial batch to the batch size
(its padded rows have n_eff = 0), and scatter the outputs into
`<shape>.normals`, `.experts` and `.experts_probs`.

`moe_inference="sparse"` (the default, as in JAX) computes the MuPS grid
once, runs the manager on the whole padded batch and then each real patch
through its argmax expert only, on JAX's schedule (`SparseMoeRouter`):
each batch's grid is parked in a FIFO of W slots, the manager's
probabilities are processed `depth` batches late, each batch's winners
are appended to per-expert buckets, and an expert runs when its bucket
holds a batch's worth of rows, which usually come from several batches;
a slot's rows are flushed before it is overwritten, the rest at the end,
and a partial run is padded with the FIFO's first row.  The runs hold the
same rows in the same order as JAX's, so under int8, where every conv and
linear quantizes its whole input at one scale, a patch's normal is the
one JAX computes.  `"dense"` runs every expert on every patch and keeps
the argmax expert's normal.  Not ported: the device-side donation, the
asynchronous copies and the flat (8, 128)-lane layout of JAX's FIFO.

The noise-switching model goes through the same router: its gate is the
noise CNN on the whole padded batch, each real patch's branch is
`noise < 0.015` (`models/switching.py::route`), and each branch runs on
its radius's 20 channels of the parked grid in the experts' runs.  Routed,
it writes `.normals`, `.experts` (the branch: 0 the small radius, 1 the
large) and `.noise` (the estimate); `"dense"` runs all three CNNs on every
patch, as JAX does, and writes `.normals` only.  The single-scale and
multi-scale models are served dense on the whole padded batch, as JAX does
(`nestinet_tpu/infer/predict.py:294-330`): they write `.normals` only, and
`moe_inference` is ignored.

Every call, here and in `infer/device_pipeline.py`, is one job
(`serve_job`) over a source of padded batches' MuPS grids: `HostBatches`
here, `device_pipeline.py::DeviceBatches` there.  The job asks the model
what it serves and writes (`models/base.py::ModelBase`): whether it is
routed (`n_experts`), its gate's file in each mode (`gate_files`), the
stats key of its routes (`routes_stat`) and a dense batch's outputs
(`serve_dense`).  Under a `torch.profiler` session a job records its
spans and counters (`core/profiling.py`) and returns them in its stats'
`trace`.

`compute_dtype` and `fold_bn` override the run's config for one call, as
in JAX; `None` keeps the config's.  The run dir's torch checkpoint is
served, or the JAX trainer's msgpack checkpoint when it holds no torch one
(`core/checkpoint.py`).

`data_parallel` (JAX's signature and assert, `:296-313`) serves on that
many ranks (`train/distributed.py::launch`): each rank extracts whole
global batches, batch i on rank i mod N (`data/loader.py`, "batches"
shards), and rank 0 gathers the outputs and writes them in the batches'
order (`RankOutputs`).  Every batch is the one a single process forms, so
every manager's int8 activation scale is too.  Routed, every rank
all-gathers each global batch's grid and probabilities, holds the whole
FIFO and computes the one schedule; run k executes on rank k mod N, and
rank 0 takes each patch's normal from the rank that ran it.  So the files
equal one process's without a collective inside the model.  JAX instead
shards each batch's rows over its mesh, where XLA takes the int8 amax
over the global batch and moves the bucket rows between shards.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..core import checkpoint, profiling
from ..core.config import Config
from ..core.device import resolve_device, set_f32_numerics
from ..core.rundir import RunDir
from ..data.loader import get_data_loader
from ..models import build_model
from ..ops.fold import fold_bn_
from ..ops.gmm import GridGMM
from ..ops.kernels import int8_cuda, mups_cuda, pool_cuda
from ..ops.quant import quantize_
from ..train import distributed
from ..train.mesh import make_mesh
from .writer import ShapeScatterWriter


def load_run(run_dir: str, device: torch.device, compute_dtype: str | None = None,
             fold_bn: bool | None = None):
    """(run dir, cfg, gmm, model) with the checkpoint loaded on `device`, in
    eval mode: the best-validation checkpoint when the trainer wrote one,
    else the periodic one, as JAX's `restore_model` prefers `ckpt_best/`
    (`:164-169`); the torch trainer's, or the JAX trainer's when the run
    dir holds no torch checkpoint.

    The weights exist once, on `device`: the model is built there without
    initialising them (JAX's `restore_model` builds its templates with
    `jax.eval_shape`, `:197-203`), the checkpoint is read mapped from its
    file and copied to the device once, and `load_state_dict` (strict) then
    fills every parameter and state tensor, so a checkpoint that lacks one
    raises.  The BatchNorms are folded (with `fold_bn`) and then the kernels
    quantized (int8) on those tensors, on the device, in float32 torch ops
    that give JAX's NumPy numbers bit for bit (`:207-222`, `ops/fold.py`,
    `ops/quant.py`)."""
    device = torch.device(device)
    with profiling.span("load_run"):
        rd = RunDir.open(run_dir)
        cfg = Config.load(rd.config_path)
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        if fold_bn is not None:
            cfg = dataclasses.replace(cfg, fold_bn=bool(fold_bn))
        gmm = GridGMM.load(rd.gmm_path)
        with profiling.span("load_run.build"):
            with device:
                model = build_model(cfg, gmm, init=False)
            model.to(device)  # the GMM's buffers, made from NumPy arrays
        with profiling.span("load_run.read"):
            payload = checkpoint.load_for_serving(rd.path, torch.device("cpu"), cfg)
        with profiling.span("load_run.upload"):
            state = {k: v.to(device) for k, v in payload.pop("state_dict").items()}
        with profiling.span("load_run.load_state"):
            check_widths(model, state, run_dir, cfg.model)
            model.load_state_dict(state)
            del state
        if model.fold_bn:
            with profiling.span("load_run.fold", device=True):
                fold_bn_(model)
        if model.quantize:
            with profiling.span("load_run.quantize", device=True):
                quantize_(model)
        model.eval()
    return rd, cfg, gmm, model


def check_widths(model: torch.nn.Module, state_dict: dict, run_dir: str, model_name: str):
    """Raise a ValueError naming the first tensor whose shape differs
    between the checkpoint and the model that config.json builds, with the
    model's `widths_hint`."""
    want = model.state_dict()
    bad = [k for k, v in state_dict.items() if k in want and v.shape != want[k].shape]
    if not bad:
        return
    k = bad[0]
    raise ValueError(f"{run_dir}: the checkpoint does not fit the {model_name} of its "
                     f"config.json: {len(bad)} tensors differ, first {k}, "
                     f"{tuple(state_dict[k].shape)} in the checkpoint and "
                     f"{tuple(want[k].shape)} in the model." + model.widths_hint)


def pad_batch(batch: dict, batch_size: int) -> dict:
    """Zero-pad a partial batch to the batch size."""
    real = batch["points"].shape[0]
    if real == batch_size:
        return batch
    out = {}
    for k, v in batch.items():
        pad_shape = (batch_size - real,) + v.shape[1:]
        out[k] = np.concatenate([v, np.zeros(pad_shape, v.dtype)], axis=0)
    return out


MOE_INFERENCE = ("sparse", "dense")


class SparseMoeRouter:
    """JAX's `SparseMoeRouter` (`nestinet_tpu/infer/predict.py:423-778`): the
    same expert runs, with the same rows in the same order and the same pad
    rows, in plain PyTorch on `device`.  The model gives the gate each batch
    is queued with (`gate`: the manager's probabilities [E, B], or the
    switching model's noise [1, B]), each patch's route from its host copy
    (`route`: the first maximum, or the branch of `noise < 0.015`) and the
    routes' networks (`expert_on_grid`); the switching model's two branches
    take the experts' place.

      * The window: W = max(2, window_slots), or max(2, 8192 // B) when
        `window_slots` is None or 0.  The FIFO holds W padded grids of B
        rows in the model's compute dtype (bfloat16 under int8), as JAX
        parks them (`:793-795`).
      * The depth: min(NESTINET_MANAGER_DEPTH or 3, W - 2) if W > 2, else
        1 (`:524-525`).  The manager's probabilities of batch i are
        processed once batch i + depth is committed.
      * Batch i (`begin_batch`, `commit`): from i = W on, slot i mod W is
        evicted first: for e = 0..E-1, the bucket's leading rows parked in
        that slot run now (`:733-751`).  Then the grid is parked in the
        slot and its gate queued; the oldest queued batch, while more than
        `depth` are queued, is processed: each patch routed (`route`), each
        winner's rows appended to its expert's bucket in
        `np.unique` order, then for e = 0..E-1, while the bucket holds B
        rows or more, exactly B run (`:753-778`).
      * `finish`: the queue processed, then for e = 0..E-1 the buckets
        flushed in runs of min(count, B) (`:579-588`).
      * A run of n < B rows is padded to max(32, B // 4) rows if n is at
        most that, else to B, with the FIFO's slot 0, row 0 as the slot
        holds it when the run starts (`:639-654`); the pad rows go through
        the expert, since they set its int8 scales, and their normals are
        dropped; a job's counter `pad_rows` adds them up (`core/profiling.py`).
        The expert takes its channel slice of the gathered rows
        (`expert_on_grid`, as `_expert_on_buf` `:839-873`).

    Outputs reach `emit(normals [n, 3], ids [n], gate [n, G])` in patch
    order, as NumPy arrays.

    On the ranks of a data-parallel mesh (`mesh.size` > 1) every rank feeds
    every global batch through `serve`, in the global order: each round,
    the ranks all-gather their batches' grids and gates (`reals`
    gives every global batch's real patch count), so every rank holds the
    whole FIFO and computes the one schedule.  Rank r executes run k when
    k mod N = r; the others mark its patches done with zero normals, and
    `own` keeps the (patch ids, normals) of the runs this rank executed.
    """

    def __init__(self, model, batch_size: int, emit, *, device: torch.device,
                 window_slots: int | None = None, mesh=None, reals=None):
        self.model = model
        self.batch_size = batch_size
        self.emit = emit
        self.W = max(2, window_slots) if window_slots else max(2, 8192 // batch_size)
        depth = int(os.environ.get("NESTINET_MANAGER_DEPTH", "3"))
        self.depth = min(depth, self.W - 2) if self.W > 2 else 1
        res, channels = model.resolution, 20 * model.cfg.n_scales
        self.fifo = torch.zeros((self.W * batch_size, res, res, res, channels),
                                dtype=model.compute_dtype, device=device)
        self.mesh = mesh
        self.rank, self.ranks = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
        self.reals = list(reals) if reals is not None else None
        if self.ranks > 1 and self.reals is None:
            raise ValueError("a router on several ranks needs every global batch's `reals`")
        n = model.n_experts
        self.buckets = [[] for _ in range(n)]  # segments (patch ids, FIFO rows, batch)
        self.bucket_count = [0] * n
        self.queue = []  # (batch, real, gate [G, real]) not yet processed
        self.meta = []  # (first patch, ids [real], gate [real, G]), batch order
        self.own = []
        # the patches not yet emitted: from the oldest batch still in the FIFO on
        self.R = (self.W + 1) * batch_size
        self.ring = np.zeros((self.R, 3), np.float32)
        self.ready = np.zeros(self.R, bool)
        self.batch_i = self.n_patches = self.emit_ptr = self.round = 0
        self.expert_runs = self.forced_flushes = self.executed = 0

    # ---- JAX's driver protocol ----
    def begin_batch(self) -> int:
        """Evict the slot that the next batch overwrites; returns it."""
        slot = self.batch_i % self.W
        if self.batch_i >= self.W:
            self._evict(slot)
        return slot

    def commit(self, real: int, probs: torch.Tensor, grid: torch.Tensor) -> None:
        """Park a batch's padded grid [B, r, r, r, C] in its slot and queue
        its gate [G, B]."""
        slot = self.batch_i % self.W
        b = self.batch_size
        self.fifo[slot * b:(slot + 1) * b].copy_(grid)
        self.queue.append((self.batch_i, real, probs[:, :real]))
        while len(self.queue) > self.depth:
            self._process(*self.queue.pop(0))
        self.batch_i += 1

    def finish(self) -> dict:
        """Run what is left and emit every patch; returns the schedule's
        counts."""
        if self.ranks > 1:
            while self.round < -(-len(self.reals) // self.ranks):
                self.serve(0, torch.zeros_like(self.fifo[:self.batch_size]), torch.zeros(
                    (self.model.gate_rows, self.batch_size), device=self.fifo.device))
        while self.queue:
            self._process(*self.queue.pop(0))
        for e in range(len(self.buckets)):
            while self.bucket_count[e]:
                self._run(e, *self._take(e, min(self.bucket_count[e], self.batch_size)))
        self._emit()
        if self.emit_ptr != self.n_patches:
            raise RuntimeError(f"the router emitted {self.emit_ptr} of {self.n_patches} patches")
        return {"expert_runs": self.expert_runs, "forced_flushes": self.forced_flushes,
                "window_slots": self.W}

    def serve(self, real: int, grid: torch.Tensor, probs: torch.Tensor) -> None:
        """This rank's next batch (`real` real rows of the padded grid, its
        gate [G, B]): on one rank straight through
        `begin_batch` and `commit`; on several, every rank's batch of the
        round, in the global order."""
        if self.ranks == 1:
            self.begin_batch()
            self.commit(real, probs, grid)
            return
        parts = [grid.reshape(-1).view(torch.uint8),
                 probs.to(torch.float32).contiguous().reshape(-1).view(torch.uint8)]
        with profiling.span("router.all_gather"):
            gathered = self.mesh.all_gather_tensor(torch.cat(parts))
        cut = parts[0].numel()
        for r, flat in enumerate(gathered):
            i = self.round * self.ranks + r
            if i < len(self.reals):
                self.begin_batch()
                self.commit(self.reals[i], flat[cut:].view(torch.float32).view(probs.shape),
                            flat[:cut].view(grid.dtype).view(grid.shape))
        self.round += 1

    # ---- internals ----
    def _process(self, b: int, real: int, probs: torch.Tensor) -> None:
        probs = profiling.fetch("fetch.probs", probs).numpy()  # [G, real]
        ids = self.model.route(probs)
        base = self.n_patches
        idxs = base + np.arange(real, dtype=np.int64)
        flats = (b % self.W) * self.batch_size + np.arange(real, dtype=np.int64)
        self.meta.append((base, ids, np.ascontiguousarray(probs.T)))
        for e in np.unique(ids):
            m = ids == e
            self.buckets[int(e)].append((idxs[m], flats[m], b))
            self.bucket_count[int(e)] += int(m.sum())
        self.n_patches += real
        for e in range(len(self.buckets)):
            while self.bucket_count[e] >= self.batch_size:
                self._run(e, *self._take(e, self.batch_size))
        self._emit()

    def _take(self, e: int, n: int):
        """The first n rows of bucket e: (patch ids [n], FIFO rows [n])."""
        segs = self.buckets[e]
        parts_i, parts_f, got = [], [], 0
        while got < n:
            i, f, b = segs[0]
            need = n - got
            if i.shape[0] <= need:
                segs.pop(0)
            else:
                segs[0] = (i[need:], f[need:], b)
                i, f = i[:need], f[:need]
            parts_i.append(i)
            parts_f.append(f)
            got += i.shape[0]
        self.bucket_count[e] -= n
        return np.concatenate(parts_i), np.concatenate(parts_f)

    def _evict(self, slot: int) -> None:
        """Run every bucket's leading rows parked in `slot`, experts in order."""
        for e, segs in enumerate(self.buckets):
            take_i, take_f = [], []
            while segs and segs[0][2] % self.W == slot:
                i, f, _ = segs.pop(0)
                take_i.append(i)
                take_f.append(f)
            if take_i:
                idxs, flats = np.concatenate(take_i), np.concatenate(take_f)
                self.bucket_count[e] -= idxs.shape[0]
                self._run(e, idxs, flats)

    def _run(self, e: int, idxs: np.ndarray, flats: np.ndarray) -> None:
        """One expert run over the given FIFO rows, padded as JAX pads."""
        k = self.expert_runs
        self.expert_runs += 1
        n = idxs.shape[0]
        if n < self.batch_size:
            self.forced_flushes += 1
            small = max(32, self.batch_size // 4)
            target = small if n <= small else self.batch_size
            flats = np.concatenate([flats, np.zeros(target - n, np.int64)])
        if k % self.ranks != self.rank:
            self._complete(idxs, None)
            return
        profiling.count("pad_rows", flats.shape[0] - n)
        with profiling.span("router.expert", device=True):
            index = profiling.upload("upload.index", flats, self.fifo.device)
            normals = self.model.expert_on_grid(e, self.fifo.index_select(0, index))[:n]
        normals = profiling.fetch("fetch.normals", normals).numpy()
        self.executed += 1
        self._complete(idxs, normals)
        if self.ranks > 1:
            self.own.append((idxs, normals))

    def _complete(self, idxs: np.ndarray, normals) -> None:
        if int(idxs.max()) - self.emit_ptr >= self.R:
            raise RuntimeError("the router's ring of normals lapped its unread tail")
        slots = idxs % self.R
        self.ring[slots] = 0.0 if normals is None else normals
        self.ready[slots] = True

    def _emit(self) -> None:
        """Emit the completed prefix of the patches, in patch order."""
        start, parts = self.emit_ptr, []
        while self.emit_ptr < self.n_patches:
            s = self.emit_ptr % self.R
            span = min(self.R - s, self.n_patches - self.emit_ptr)
            flags = self.ready[s:s + span]
            k = span if flags.all() else int(np.argmin(flags))
            if k == 0:
                break
            parts.append(self.ring[s:s + k].copy())
            self.ready[s:s + k] = False
            self.emit_ptr += k
        if not parts:
            return
        ids, probs = [], []
        while self.meta:
            base, b_ids, b_probs = self.meta[0]
            lo, hi = max(base, start), min(base + b_ids.shape[0], self.emit_ptr)
            if hi <= lo:
                break
            ids.append(b_ids[lo - base:hi - base])
            probs.append(b_probs[lo - base:hi - base])
            if hi < base + b_ids.shape[0]:
                break
            self.meta.pop(0)
        self.emit(np.concatenate(parts), np.concatenate(ids).astype(np.int64),
                  np.concatenate(probs))


def _host(t) -> np.ndarray | None:
    if t is None or isinstance(t, np.ndarray):
        return t
    return profiling.fetch("fetch.outputs", t).numpy()


def append_outputs(writer, rows: np.ndarray, normals, experts, probs) -> None:
    """Outputs in patch order (tensors or NumPy arrays) to the writer; the
    experts' or branches' ids are counted into `rows`."""
    if experts is None:
        writer.append(_host(normals))
        return
    experts = _host(experts)
    rows += np.bincount(experts, minlength=rows.shape[0])
    writer.append(_host(normals), experts, _host(probs))


def serving_stats(model, cfg, rows: np.ndarray) -> dict:
    """The model, dtype and routing fields of a serving call's stats: the
    patches each route served under the model's `routes_stat`."""
    out = {"model": cfg.model, "compute_dtype": cfg.compute_dtype, "fold_bn": model.fold_bn}
    if model.routes_stat is not None:
        rows = rows.tolist()
        out[model.routes_stat] = (rows if model.route_names is None
                                  else dict(zip(model.route_names, rows)))
    return out


def kernel_launches() -> dict:
    """The CUDA kernels' launch counts so far, by kernel."""
    return {**mups_cuda.KERNEL.launches,
            **{k: v for lib in (*pool_cuda.KERNELS, *int8_cuda.KERNELS)
               for k, v in lib.launches.items()}}


class RankOutputs:
    """Where a serving call's outputs go.  One process: straight to the
    writer (`append_outputs`).  A data-parallel rank served dense keeps the
    outputs of the global batches it serves (batch i on rank i mod N) until
    `finish`, where rank 0 gathers every rank's and writes them in the
    global order.  Served routed (`routed`), every rank's router emits
    every patch in order, rank 0 keeps them, and at `finish` it takes each
    patch's normal from the rank that ran its expert (`SparseMoeRouter.own`).
    `make_writer` builds the writer, on rank 0 only; `served` counts a batch
    this rank computed."""

    def __init__(self, mesh, make_writer, rows: np.ndarray, routed: bool = False):
        self.mesh = mesh
        self.rows = rows
        self.routed = routed
        self.writer = make_writer() if mesh.is_main else None
        self.parts: list = []
        self.n_patches = self.n_batches = 0
        self._launches = kernel_launches()

    def served(self, real: int) -> None:
        self.n_patches += real
        self.n_batches += 1

    def add(self, normals, experts, probs) -> None:
        if self.mesh.size == 1:
            append_outputs(self.writer, self.rows, normals, experts, probs)
            return
        if self.routed and not self.mesh.is_main:
            return
        out = tuple(map(_host, (normals, experts, probs)))
        if out[1] is not None:
            self.rows += np.bincount(out[1], minlength=self.rows.shape[0])
        self.parts.append(out)

    def finish(self, router: SparseMoeRouter | None = None) -> dict | None:
        """Rank 0: writes the gathered outputs and returns the call's counts
        (`n_patches`, `n_batches`, the summed `rows`, and `per_rank`: each
        rank's patches, batches, kernel launches and, routed, the expert runs
        it executed); None on the others."""
        launches = {k: v - self._launches[k] for k, v in kernel_launches().items()}
        mine = {"n_patches": self.n_patches, "n_batches": self.n_batches,
                "launches": launches}
        if router is not None:
            mine["expert_runs"] = router.executed
        own = router.own if router is not None else None
        gathered = self.mesh.gather_to_main((self.parts, self.rows, mine, own))
        if not self.mesh.is_main:
            return None
        if self.mesh.size > 1 and self.routed:
            normals, experts, probs = (np.concatenate([p[i] for p in self.parts])
                                       for i in range(3))
            filled = np.zeros(normals.shape[0], bool)
            for g in gathered:
                for idxs, n in g[3]:
                    normals[idxs] = n
                    filled[idxs] = True
            if not filled.all():
                raise RuntimeError(f"no rank ran the experts of {int((~filled).sum())} patches")
            self.writer.append(normals, experts, probs)
        elif self.mesh.size > 1:
            parts = [g[0] for g in gathered]
            for i in range(sum(map(len, parts))):
                self.writer.append(*parts[i % self.mesh.size][i // self.mesh.size])
        if not self.writer.done:
            raise RuntimeError("the writer did not receive every shape's patches")
        per_rank = [g[2] for g in gathered]
        return {"n_patches": sum(r["n_patches"] for r in per_rank),
                "n_batches": sum(r["n_batches"] for r in per_rank),
                "rows": sum(g[1] for g in gathered), "per_rank": per_rank}


def serve_batch(model, router, outputs: RankOutputs, grid: torch.Tensor, real: int) -> None:
    """One padded batch's grid this rank computed: routed (the gate here,
    the routes' runs in the router) or dense (`serve_dense`)."""
    outputs.served(real)
    with profiling.span("batch.model", device=True):
        out = model.serve_dense(grid, real) if router is None else model.gate(grid)
    if router is not None:
        with profiling.span("router.commit"):
            router.serve(real, grid, out)
        return
    normals, ids, gate, counts = out
    if counts is not None:
        outputs.rows += counts
    outputs.add(normals, ids, gate)


class HostBatches:
    """The batch source of `predict_shapes`: the patches extracted on the
    host by the loader (`data/loader.py`, the kd-tree), this rank's global
    batches (batch i on rank i mod N), each zero-padded to the batch size,
    uploaded, and made into its MuPS grid.  `stats` gives the seconds spent
    waiting for the loader."""

    def __init__(self, model, cfg, mesh, dev, indir: str, testset: str, batch_size: int,
                 sparse_patches: bool, *, loader_workers: int):
        self.model, self.dev, self.batch_size = model, dev, batch_size
        self.loader, dataset = get_data_loader(
            testset,
            indir=indir,
            batch_size=batch_size,
            patch_radius=cfg.patch_radius,
            points_per_patch=cfg.num_point,
            seed=cfg.seed,
            patch_center=cfg.patch_center,
            use_pca=cfg.use_pca,
            cache_capacity=cfg.cache_capacity,
            workers=loader_workers,
            sparse_patches=sparse_patches,
            shard=(mesh.rank, mesh.size, "batches") if mesh.size > 1 else None,
        )
        self.shape_names, self.counts = dataset.shape_names, dataset.shape_patch_count
        total = sum(self.counts)  # the loader pads the stream's last batch
        self.reals = [min(batch_size, total - s) for s in range(0, total, batch_size)]
        self.loader_wait = 0.0

    def __iter__(self):
        """(grid, real patches) of each of this rank's batches."""
        batches = iter(self.loader)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            self.loader_wait += time.perf_counter() - t_wait
            if batch is None:
                return
            real = batch["points"].shape[0]
            batch = pad_batch(batch, self.batch_size)
            points = profiling.upload("upload.points", batch["points"], self.dev)
            n_eff = profiling.upload("upload.n_eff", batch["n_eff"].astype(np.int32), self.dev)
            with profiling.span("batch.mups", device=True):
                grid = self.model.mups_grid(points, n_eff)
            yield grid, real

    def stats(self) -> dict:
        return {"loader_wait_seconds": self.loader_wait}


def launch(source, run_dir: str, *, moe_inference: str, batch_size: int, data_parallel: int,
           device, backend: str | None, **kwargs) -> dict:
    """`predict_shapes` or `predict_shapes_device`: the arguments checked,
    then `serve_job` over the batch source `source` on `data_parallel`
    ranks (`backend` as in `distributed.launch`); rank 0's stats."""
    if moe_inference not in MOE_INFERENCE:
        raise ValueError(f"moe_inference must be one of {MOE_INFERENCE}, got {moe_inference!r}")
    if data_parallel > 1:
        assert batch_size % data_parallel == 0, "batch_size must divide by data_parallel"
    kwargs.update(moe_inference=moe_inference, batch_size=batch_size,
                  data_parallel=data_parallel, device=device)
    return distributed.launch(serve_job, data_parallel, (run_dir, source), kwargs,
                              device=device, backend=backend)


def serve_job(run_dir: str, source, *, data_parallel, device, dataset_name, testset, data_path,
              batch_size, sparse_patches, output_dir, moe_inference, sparse_window_slots,
              compute_dtype, fold_bn, **source_options) -> dict | None:
    """Every serving job, on one rank of `data_parallel`: the run dir
    loaded, the batch source `source` built (`HostBatches`, or
    `device_pipeline.py::DeviceBatches`, with `source_options`), the writer,
    the outputs and, where the model is routed, the router; then each batch
    served, the router and the outputs finished, and the stats.  `seconds`
    times the loop, from its first batch to the last file written.  Under a
    `torch.profiler` session the job records its spans and counters
    (`core/profiling.py`) and returns them in its stats' `trace`."""
    mesh = make_mesh(data_parallel)
    dev = resolve_device(device)
    with profiling.job(dev) as job:
        set_f32_numerics()
        rd, cfg, _, model = load_run(run_dir, dev, compute_dtype, fold_bn)
        indir = data_path if data_path is not None else cfg.data_path
        out_dir = output_dir if output_dir is not None else rd.results_dir(dataset_name)
        batches = source(model, cfg, mesh, dev, indir, testset, batch_size, sparse_patches,
                         **source_options)
        gate_file = model.gate_files.get(moe_inference)
        routed = moe_inference == "sparse" and model.n_experts > 0
        outputs = RankOutputs(mesh, lambda: ShapeScatterWriter(
            out_dir, batches.shape_names, batches.counts, gate_file, model.gate_rows,
        ), np.zeros(model.n_experts, np.int64), routed=routed)
        router = SparseMoeRouter(model, batch_size, outputs.add, device=dev,
                                 window_slots=sparse_window_slots, mesh=mesh,
                                 reals=batches.reals) if routed else None

        t0 = time.perf_counter()
        with profiling.span("loop"):
            with torch.inference_mode():
                for grid, real in batches:
                    serve_batch(model, router, outputs, grid, real)
                routing = {}
                if router is not None:
                    with profiling.span("router.finish"):
                        routing = router.finish()
            with profiling.span("outputs.finish"):
                counts = outputs.finish(router)
        elapsed = time.perf_counter() - t0
    if counts is None:
        return job.attach(None)
    return job.attach(serving_stats(model, cfg, counts.pop("rows")) | counts | routing | {
        "seconds": elapsed,
        "patches_per_sec": counts["n_patches"] / elapsed if elapsed > 0 else float("inf"),
        "moe_inference": moe_inference,
        "data_parallel": mesh.size,
        **batches.stats(),
        "shapes": outputs.writer.written,
        "output_dir": out_dir,
        "device": str(dev),
    })


def predict_shapes(
    run_dir: str,
    *,
    dataset_name: str = "pcpnet",
    testset: str = "testset.txt",
    data_path: str | None = None,
    batch_size: int = 128,
    sparse_patches: bool = False,
    loader_workers: int = 8,
    output_dir: str | None = None,
    moe_inference: str = "sparse",
    compute_dtype: str | None = None,
    sparse_window_slots: int | None = None,
    fold_bn: bool | None = None,
    data_parallel: int = 1,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> dict:
    """Inference with host patch extraction for every shape in `testset`
    (or each shape's `.pidx` subset with `sparse_patches`); returns stats,
    with the patches each expert or branch served (`serving_stats`), each
    rank's patches and kernel launches (`per_rank`) and, routed, the
    router's `expert_runs`, `forced_flushes` and `window_slots`
    (`sparse_window_slots` as JAX's).  `data_parallel` > 1 serves on that
    many ranks (`backend` as in `distributed.launch`), whole batches each,
    and returns rank 0's stats."""
    return launch(HostBatches, **locals())  # the arguments above, as given
