"""Streaming whole-shape inference, in float32, bfloat16 or int8,
optionally with BatchNorm folded: the mixture of experts routed or dense,
the single-scale, multi-scale and noise-switching models dense.

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

A model other than the mixture of experts is served dense on its whole
padded batch, as JAX does (`nestinet_tpu/infer/predict.py:294-330`): it
writes `.normals` only, and `moe_inference` is ignored.

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
from ..models import ExpertsNormEst, SwitchingNormEst, build_model
from ..models.switching import NOISE_SWITCH_THRESHOLD
from ..ops.fold import fold_bn_
from ..ops.gmm import GridGMM
from ..ops.kernels import int8_cuda, mups_cuda
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
    between the checkpoint and the model that config.json builds.  The
    switching model's CNNs take `models/backbones.py::SW_BACKBONE`, which
    config.json does not record: a run trained with it narrowed is served
    only with the same narrowing."""
    want = model.state_dict()
    bad = [k for k, v in state_dict.items() if k in want and v.shape != want[k].shape]
    if not bad:
        return
    hint = (" The switching model's CNNs take models/backbones.py::SW_BACKBONE, which "
            "config.json does not record: a run trained with it narrowed (as "
            "nestinet_tpu_torch/testdata/jax_run_switching) is served with the same "
            "narrowing." if model_name == "ms_sw_n_est" else "")
    k = bad[0]
    raise ValueError(f"{run_dir}: the checkpoint does not fit the {model_name} of its "
                     f"config.json: {len(bad)} tensors differ, first {k}, "
                     f"{tuple(state_dict[k].shape)} in the checkpoint and "
                     f"{tuple(want[k].shape)} in the model." + hint)


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


def route_sparse(model, grid: torch.Tensor, real: int):
    """Argmax-only mixture of experts on one [B, r, r, r, C] grid whose first
    `real` rows are real patches (the rest are padding): the one-batch
    routing primitive.  Serving no longer goes through it: its runs hold one
    batch's rows, where JAX's router gathers them across batches
    (`SparseMoeRouter`), so under int8 its normals are not JAX's.

    The manager runs on the whole padded batch; each real patch then runs
    through exactly one expert, its argmax (first maximum on ties, as
    jnp.argmax): per expert with any rows, `index_select` its patches'
    grids, run the expert, `index_copy` the normals back.  Padded rows
    never reach an expert.

    Returns (normals [real, 3], expert ids [real], probabilities
    [real, E]), the ids and probabilities being the manager's.
    """
    probs = model.manager_probs(grid)[:, :real]  # [E, real]
    ids = torch.argmax(probs, dim=0)
    counts = torch.bincount(ids, minlength=model.n_experts).tolist()
    order = torch.argsort(ids, stable=True)  # patches grouped by expert
    normals = torch.empty((real, 3), dtype=torch.float32, device=grid.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        rows = order[start : start + n]
        start += n
        normals.index_copy_(0, rows, model.expert_on_grid(e, grid.index_select(0, rows)))
    return normals, ids, probs.t()


class SparseMoeRouter:
    """JAX's `SparseMoeRouter` (`nestinet_tpu/infer/predict.py:423-778`): the
    same expert runs, with the same rows in the same order and the same pad
    rows, in plain PyTorch on `device`.

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
        slot and its probabilities queued; the oldest queued batch, while
        more than `depth` are queued, is processed: argmax (the first
        maximum), each winner's rows appended to its expert's bucket in
        `np.unique` order, then for e = 0..E-1, while the bucket holds B
        rows or more, exactly B run (`:753-778`).
      * `finish`: the queue processed, then for e = 0..E-1 the buckets
        flushed in runs of min(count, B) (`:579-588`).
      * A run of n < B rows is padded to max(32, B // 4) rows if n is at
        most that, else to B, with the FIFO's slot 0, row 0 as the slot
        holds it when the run starts (`:639-654`); the pad rows go through
        the expert, since they set its int8 scales, and their normals are
        dropped.  The expert takes its channel slice of the gathered rows
        (`expert_on_grid`, as `_expert_on_buf` `:839-873`).

    Outputs reach `emit(normals [n, 3], ids [n], probabilities [n, E])` in
    patch order, as NumPy arrays.

    On the ranks of a data-parallel mesh (`mesh.size` > 1) every rank feeds
    every global batch through `serve`, in the global order: each round,
    the ranks all-gather their batches' grids and probabilities (`reals`
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
        self.queue = []  # (batch, real, probabilities [E, real]) not yet processed
        self.meta = []  # (first patch, ids [real], probabilities [real, E]), batch order
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
        its probabilities [E, B]."""
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
                    (self.model.n_experts, self.batch_size), device=self.fifo.device))
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
        """This rank's next batch (`real` real rows of the padded grid, the
        manager's probabilities [E, B]): on one rank straight through
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
        probs = profiling.fetch("fetch.probs", probs).numpy()  # [E, real]
        ids = np.argmax(probs, axis=0)
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


def is_moe(model) -> bool:
    return isinstance(model, ExpertsNormEst)


def route_rows(model, cfg) -> np.ndarray:
    """Zeroed patch counts per route of a serving call: per expert for the
    mixture of experts, per branch (small-scale, large-scale) for the
    switching model, none for the other models."""
    if is_moe(model):
        return np.zeros(cfg.n_experts, np.int64)
    return np.zeros(2 if isinstance(model, SwitchingNormEst) else 0, np.int64)


def serve_grid(model, grid: torch.Tensor, real: int, rows: np.ndarray):
    """(normals [real, 3], expert ids [real], probabilities [real, E]) of
    one padded batch's grid served dense; a model other than the mixture of
    experts gives (normals, None, None), the switching model counting its
    patches per branch into `rows` (`route_rows`).  Routed serving goes
    through `SparseMoeRouter`."""
    if not is_moe(model):
        outputs = model.forward_grid(grid)
        if isinstance(model, SwitchingNormEst):
            small = int(profiling.fetch("fetch.outputs",
                                        (outputs["noise_pred"][:real] < NOISE_SWITCH_THRESHOLD).sum()))
            rows += (small, real - small)
        return model.predict_normals(outputs)[:real], None, None
    outputs = model.forward_grid(grid)
    ids, probs = model.predict_experts(outputs)
    return model.predict_normals(outputs)[:real], ids[:real], probs[:real]


def _host(t) -> np.ndarray | None:
    if t is None or isinstance(t, np.ndarray):
        return t
    return profiling.fetch("fetch.outputs", t).numpy()


def append_outputs(writer, rows: np.ndarray, normals, experts, probs) -> None:
    """Outputs in patch order (tensors or NumPy arrays) to the writer; the
    mixture of experts' ids are counted into `rows`."""
    if experts is None:
        writer.append(_host(normals))
        return
    experts = _host(experts)
    rows += np.bincount(experts, minlength=rows.shape[0])
    writer.append(_host(normals), experts, _host(probs))


def serving_stats(model, cfg, rows: np.ndarray) -> dict:
    """The model, dtype and routing fields of a serving call's stats:
    `expert_rows` (the mixture of experts) or `branch_rows` (the switching
    model's small- and large-scale patches)."""
    out = {"model": cfg.model, "compute_dtype": cfg.compute_dtype, "fold_bn": model.fold_bn}
    if is_moe(model):
        out["expert_rows"] = rows.tolist()
    elif rows.size:
        out["branch_rows"] = dict(zip(("small_scale", "large_scale"), rows.tolist()))
    return out


def kernel_launches() -> dict:
    """The CUDA kernels' launch counts so far, by kernel."""
    return {**mups_cuda.KERNEL.launches,
            **{k: v for lib in int8_cuda.KERNELS for k, v in lib.launches.items()}}


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


def is_routed(model, moe_inference: str) -> bool:
    return is_moe(model) and moe_inference == "sparse"


def make_router(model, moe_inference: str, outputs: RankOutputs, batch_size: int, dev,
                window_slots: int | None, reals: list) -> SparseMoeRouter | None:
    """The router of a routed mixture-of-experts call, else None; `reals`:
    every global batch's real patch count."""
    if not is_routed(model, moe_inference):
        return None
    return SparseMoeRouter(model, batch_size, outputs.add, device=dev,
                           window_slots=window_slots, mesh=outputs.mesh, reals=reals)


def serve_batch(model, router, outputs: RankOutputs, grid: torch.Tensor, real: int) -> None:
    """One padded batch's grid this rank computed: routed, dense, or the
    other models' forward."""
    outputs.served(real)
    with profiling.span("batch.model", device=True):
        out = (serve_grid(model, grid, real, outputs.rows) if router is None
               else model.manager_probs(grid))
    if router is None:
        outputs.add(*out)
    else:
        with profiling.span("router.commit"):
            router.serve(real, grid, out)


def check_moe_inference(moe_inference: str) -> None:
    if moe_inference not in MOE_INFERENCE:
        raise ValueError(f"moe_inference must be one of {MOE_INFERENCE}, got {moe_inference!r}")


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
    check_moe_inference(moe_inference)
    if data_parallel > 1:
        assert batch_size % data_parallel == 0, "batch_size must divide by data_parallel"
    kwargs = dict(dataset_name=dataset_name, testset=testset, data_path=data_path,
                  batch_size=batch_size, sparse_patches=sparse_patches,
                  loader_workers=loader_workers, output_dir=output_dir,
                  moe_inference=moe_inference, compute_dtype=compute_dtype,
                  sparse_window_slots=sparse_window_slots, fold_bn=fold_bn,
                  data_parallel=data_parallel, device=device)
    return distributed.launch(_predict_shapes, data_parallel, (run_dir,), kwargs,
                              device=device, backend=backend)


def _predict_shapes(run_dir: str, *, dataset_name, testset, data_path, batch_size,
                    sparse_patches, loader_workers, output_dir, moe_inference, compute_dtype,
                    sparse_window_slots, fold_bn, data_parallel, device) -> dict | None:
    """`predict_shapes` in this process: one rank of `data_parallel`."""
    mesh = make_mesh(data_parallel)
    dev = resolve_device(device)
    set_f32_numerics()
    rd, cfg, gmm, model = load_run(run_dir, dev, compute_dtype, fold_bn)
    indir = data_path if data_path is not None else cfg.data_path
    out_dir = output_dir if output_dir is not None else rd.results_dir(dataset_name)

    loader, dataset = get_data_loader(
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
    outputs = RankOutputs(mesh, lambda: ShapeScatterWriter(
        out_dir, dataset.shape_names, dataset.shape_patch_count,
        n_experts=cfg.n_experts if is_moe(model) else None,
    ), route_rows(model, cfg), routed=is_routed(model, moe_inference))
    total = sum(dataset.shape_patch_count)  # the loader pads the stream's last batch
    router = make_router(model, moe_inference, outputs, batch_size, dev, sparse_window_slots,
                         [min(batch_size, total - s) for s in range(0, total, batch_size)])

    loader_wait = 0.0
    t0 = time.perf_counter()
    batches = iter(loader)
    with torch.inference_mode():
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            loader_wait += time.perf_counter() - t_wait
            if batch is None:
                break
            real = batch["points"].shape[0]
            batch = pad_batch(batch, batch_size)
            points = torch.from_numpy(batch["points"]).to(dev)
            n_eff = torch.from_numpy(batch["n_eff"].astype(np.int32)).to(dev)
            serve_batch(model, router, outputs, model.mups_grid(points, n_eff), real)
        routing = router.finish() if router is not None else {}
    counts = outputs.finish(router)
    elapsed = time.perf_counter() - t0
    if counts is None:
        return None
    return serving_stats(model, cfg, counts.pop("rows")) | counts | routing | {
        "seconds": elapsed,
        "loader_wait_seconds": loader_wait,
        "patches_per_sec": counts["n_patches"] / elapsed if elapsed > 0 else float("inf"),
        "moe_inference": moe_inference,
        "data_parallel": mesh.size,
        "shapes": outputs.writer.written,
        "output_dir": out_dir,
        "device": str(dev),
    }
