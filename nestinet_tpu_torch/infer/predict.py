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
through its argmax expert only (`route_sparse`); `"dense"` runs every
expert on every patch and keeps the argmax expert's normal.  Both give the
same ids and, up to a sub-batch's summation order, the same normals; under
int8 a routed expert quantizes its own sub-batch, so its normals move a
little more.  The JAX router's FIFO slots, eviction and pipeline
depth exist for XLA's static shapes and are not ported: here each batch is
routed by `index_select` and `index_copy` per expert.

A model other than the mixture of experts is served dense on its whole
padded batch, as JAX does (`nestinet_tpu/infer/predict.py:294-330`): it
writes `.normals` only, and `moe_inference` is ignored.

`compute_dtype` and `fold_bn` override the run's config for one call, as
in JAX; `None` keeps the config's.  The run dir's torch checkpoint is
served, or the JAX trainer's msgpack checkpoint when it holds no torch one
(`core/checkpoint.py`).

`data_parallel` (JAX's signature and assert, `:296-313`) serves on that
many ranks (`train/distributed.py::launch`): each rank extracts and serves
whole global batches, batch i on rank i mod N (`data/loader.py`, "batches"
shards), and rank 0 gathers the outputs and writes them in the batches'
order (`RankOutputs`).  Every batch is the one a single process forms, so
every int8 activation scale is too, and the files equal one process's
without a collective inside the model.  JAX instead shards each batch's
rows over its mesh, where XLA takes the int8 amax over the global batch;
splitting rows here would need an all-reduce of the amax before each int8
conv and linear.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import checkpoint
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
    dir holds no torch checkpoint.  The weights are loaded in float32, then the
    BatchNorms folded (with `fold_bn`) and then the kernels quantized
    (int8), on the host, as JAX's `restore_model` does (`:207-222`)."""
    rd = RunDir.open(run_dir)
    cfg = Config.load(rd.config_path)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if fold_bn is not None:
        cfg = dataclasses.replace(cfg, fold_bn=bool(fold_bn))
    gmm = GridGMM.load(rd.gmm_path)
    model = build_model(cfg, gmm)
    payload = checkpoint.load_for_serving(rd.path, torch.device("cpu"), cfg)
    model.load_state_dict(payload["state_dict"])
    if model.fold_bn:
        fold_bn_(model)
    if model.quantize:
        quantize_(model)
    model.to(device).eval()
    return rd, cfg, gmm, model


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
    """Argmax-only mixture of experts on a [B, r, r, r, C] grid whose first
    `real` rows are real patches (the rest are padding).

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


def is_moe(model) -> bool:
    return isinstance(model, ExpertsNormEst)


def route_rows(model, cfg) -> np.ndarray:
    """Zeroed patch counts per route of a serving call: per expert for the
    mixture of experts, per branch (small-scale, large-scale) for the
    switching model, none for the other models."""
    if is_moe(model):
        return np.zeros(cfg.n_experts, np.int64)
    return np.zeros(2 if isinstance(model, SwitchingNormEst) else 0, np.int64)


def serve_grid(model, grid: torch.Tensor, real: int, moe_inference: str, rows: np.ndarray):
    """(normals [real, 3], expert ids [real], probabilities [real, E]) of
    one padded batch's grid, routed (`route_sparse`) or dense; a model
    other than the mixture of experts runs dense and gives (normals, None,
    None), the switching model counting its patches per branch into
    `rows` (`route_rows`)."""
    if not is_moe(model):
        outputs = model.forward_grid(grid)
        if isinstance(model, SwitchingNormEst):
            small = int((outputs["noise_pred"][:real] < NOISE_SWITCH_THRESHOLD).sum())
            rows += (small, real - small)
        return model.predict_normals(outputs)[:real], None, None
    if moe_inference == "sparse":
        return route_sparse(model, grid, real)
    outputs = model.forward_grid(grid)
    ids, probs = model.predict_experts(outputs)
    return model.predict_normals(outputs)[:real], ids[:real], probs[:real]


def append_outputs(writer, rows: np.ndarray, normals, experts, probs) -> None:
    """One batch's outputs to the writer; the mixture of experts' ids are
    counted into `rows`."""
    if experts is None:
        writer.append(normals.cpu().numpy())
        return
    experts = experts.cpu().numpy()
    rows += np.bincount(experts, minlength=rows.shape[0])
    writer.append(normals.cpu().numpy(), experts, probs.cpu().numpy())


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
    return {**mups_cuda.KERNEL.launches, **int8_cuda.KERNEL.launches}


class RankOutputs:
    """Where a serving call's batches go.  One process: straight to the
    writer (`append_outputs`).  A data-parallel rank keeps the outputs of
    the global batches it serves (batch i on rank i mod N) until `finish`,
    where rank 0 gathers every rank's and writes them in the global order.
    `make_writer` builds the writer, on rank 0 only."""

    def __init__(self, mesh, make_writer, rows: np.ndarray):
        self.mesh = mesh
        self.rows = rows
        self.writer = make_writer() if mesh.is_main else None
        self.parts: list = []
        self.n_patches = self.n_batches = 0
        self._launches = kernel_launches()

    def add(self, normals, experts, probs) -> None:
        self.n_patches += normals.shape[0]
        self.n_batches += 1
        if self.mesh.size == 1:
            append_outputs(self.writer, self.rows, normals, experts, probs)
            return
        out = tuple(None if t is None else t.cpu().numpy() for t in (normals, experts, probs))
        if out[1] is not None:
            self.rows += np.bincount(out[1], minlength=self.rows.shape[0])
        self.parts.append(out)

    def finish(self) -> dict | None:
        """Rank 0: writes the gathered outputs and returns the call's counts
        (`n_patches`, `n_batches`, the summed `rows`, and `per_rank`: each
        rank's patches, batches and kernel launches); None on the others."""
        launches = {k: v - self._launches[k] for k, v in kernel_launches().items()}
        mine = {"n_patches": self.n_patches, "n_batches": self.n_batches,
                "launches": launches}
        gathered = self.mesh.gather_to_main((self.parts, self.rows, mine))
        if not self.mesh.is_main:
            return None
        if self.mesh.size > 1:
            parts = [g[0] for g in gathered]
            for i in range(sum(map(len, parts))):
                self.writer.append(*parts[i % self.mesh.size][i // self.mesh.size])
        if not self.writer.done:
            raise RuntimeError("the writer did not receive every shape's patches")
        per_rank = [g[2] for g in gathered]
        return {"n_patches": sum(r["n_patches"] for r in per_rank),
                "n_batches": sum(r["n_batches"] for r in per_rank),
                "rows": sum(g[1] for g in gathered), "per_rank": per_rank}


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
    fold_bn: bool | None = None,
    data_parallel: int = 1,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> dict:
    """Inference with host patch extraction for every shape in `testset`
    (or each shape's `.pidx` subset with `sparse_patches`); returns stats,
    with the patches each expert or branch served (`serving_stats`) and
    each rank's patches and kernel launches (`per_rank`).  `data_parallel`
    > 1 serves on that many ranks (`backend` as in `distributed.launch`),
    whole batches each, and returns rank 0's stats."""
    check_moe_inference(moe_inference)
    if data_parallel > 1:
        assert batch_size % data_parallel == 0, "batch_size must divide by data_parallel"
    kwargs = dict(dataset_name=dataset_name, testset=testset, data_path=data_path,
                  batch_size=batch_size, sparse_patches=sparse_patches,
                  loader_workers=loader_workers, output_dir=output_dir,
                  moe_inference=moe_inference, compute_dtype=compute_dtype, fold_bn=fold_bn,
                  data_parallel=data_parallel, device=device)
    return distributed.launch(_predict_shapes, data_parallel, (run_dir,), kwargs,
                              device=device, backend=backend)


def _predict_shapes(run_dir: str, *, dataset_name, testset, data_path, batch_size,
                    sparse_patches, loader_workers, output_dir, moe_inference, compute_dtype,
                    fold_bn, data_parallel, device) -> dict | None:
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
    ), route_rows(model, cfg))

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
            grid = model.mups_grid(points, n_eff)
            outputs.add(*serve_grid(model, grid, real, moe_inference, outputs.rows))
    counts = outputs.finish()
    elapsed = time.perf_counter() - t0
    if counts is None:
        return None
    return serving_stats(model, cfg, counts.pop("rows")) | counts | {
        "seconds": elapsed,
        "loader_wait_seconds": loader_wait,
        "patches_per_sec": counts["n_patches"] / elapsed if elapsed > 0 else float("inf"),
        "moe_inference": moe_inference,
        "data_parallel": mesh.size,
        "shapes": outputs.writer.written,
        "output_dir": out_dir,
        "device": str(dev),
    }
