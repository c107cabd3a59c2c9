"""Streaming whole-shape inference, dense float32 mixture of experts.

Counterpart of `nestinet_tpu/infer/predict.py` (`load_run:89`,
`restore_model:154`, `predict_shapes:239` in its dense branch `:316-409`,
`_pad_batch:876`): reload a run directory's config, GMM and torch
checkpoint, walk every point of every test shape in order with the JAX
package's own host (kd-tree) loader, zero-pad the last partial batch to
the batch size (its padded rows have n_eff = 0), and scatter the outputs
into `<shape>.normals`, `.experts` and `.experts_probs`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nestinet_tpu.core.config import Config
from nestinet_tpu.core.rundir import RunDir
from nestinet_tpu.data.loader import get_data_loader

from ..core import checkpoint
from ..core.device import resolve_device, set_f32_numerics
from ..models import build_model
from ..ops.gmm import GridGMM
from .writer import ShapeScatterWriter


def load_run(run_dir: str, device: torch.device):
    """(run dir, cfg, gmm, model) with the torch checkpoint loaded on
    `device`, in eval mode."""
    rd = RunDir.open(run_dir)
    cfg = Config.load(rd.config_path)
    gmm = GridGMM.load(rd.gmm_path)
    model = build_model(cfg, gmm).to(device)
    model.load_state_dict(checkpoint.load(rd.path, device)["state_dict"])
    model.eval()
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


def predict_shapes(
    run_dir: str,
    *,
    dataset_name: str = "pcpnet",
    testset: str = "testset.txt",
    data_path: str | None = None,
    batch_size: int = 128,
    loader_workers: int = 8,
    output_dir: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Dense MoE inference for every shape in `testset`; returns stats."""
    dev = resolve_device(device)
    set_f32_numerics()
    rd, cfg, gmm, model = load_run(run_dir, dev)
    indir = data_path if data_path is not None else cfg.data_path
    out_dir = output_dir if output_dir is not None else rd.results_dir(dataset_name)

    loader, dataset = get_data_loader(
        testset,
        indir=indir,
        batch_size=batch_size,
        patch_radius=cfg.patch_radius,
        points_per_patch=cfg.num_point,
        outputs=(),  # no targets at test time
        seed=cfg.seed,
        patch_center=cfg.patch_center,
        use_pca=cfg.use_pca,
        cache_capacity=cfg.cache_capacity,
        patch_sample_order="full",
        workers=loader_workers,
    )
    writer = ShapeScatterWriter(
        out_dir, dataset.shape_names, dataset.shape_patch_count,
        n_experts=cfg.n_experts,
    )

    n_patches = n_batches = 0
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
            outputs = model(points, n_eff)
            normals = model.predict_normals(outputs)[:real]
            experts, probs = model.predict_experts(outputs)
            writer.append(
                normals.cpu().numpy(),
                experts[:real].cpu().numpy(),
                probs[:real].cpu().numpy(),
            )
            n_patches += real
            n_batches += 1
    elapsed = time.perf_counter() - t0

    if not writer.done:
        raise RuntimeError("the writer did not receive every shape's patches")
    return {
        "n_patches": n_patches,
        "n_batches": n_batches,
        "seconds": elapsed,
        "loader_wait_seconds": loader_wait,
        "patches_per_sec": n_patches / elapsed if elapsed > 0 else float("inf"),
        "shapes": writer.written,
        "output_dir": out_dir,
        "device": str(dev),
    }
