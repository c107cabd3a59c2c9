#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`nestinet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off (the JAX reference computes in float32);
  2. build: compile every kernel of the serving path with nvcc from
     `nestinet_tpu_torch/csrc/` into the gitignored build directory;
  3. kernel: the MuPS CUDA kernel against its plain PyTorch version on the
     card at the flagship shape (384 rows = 128 patches x 3 scales, 512
     points, 512 Gaussians), unpadded, randomly padded and with n_eff = 0
     rows, at atol 1e-5; its gradient at a small shape at atol 1e-4;
  4. slice: a full-width `experts_n_est` run dir (3 radii, 512 points, 8^3
     Gaussians, 7 experts, random weights from a seed) serves a synthetic
     protocol testset through `predict_shapes` at batch 128; the launch
     counts show the main path went through every kernel; every
     `.normals` row is finite, every `.experts` id in [0, 7); the outputs
     are scored by `eval/evaluate.py`; one batch is compared with the same
     model on the plain MuPS (argmax ids identical, normals at atol 1e-4);
  5. times: kernel and plain MuPS (CUDA events, median of 20 after
     warm-up), the model's forward, the slice's patches/s and peak memory.

The line before the last is the card as nvidia-smi reports it; the one
before that is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  `--record PATH` also writes every number
measured to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 3627473
BATCH = 128
N_POINTS = 5000  # points per synthetic shape; the testset has 6 shapes
KERNEL_ATOL = 1e-5
GRAD_ATOL = 1e-4
NORMALS_ATOL = 1e-4


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def flagship_rows(gen, R, N, mode, device):
    """Random points in [-1, 1]^3 with n_eff per `mode`; rows past n_eff are
    zero, as the loader pads them."""
    import torch

    pts = torch.rand((R, N, 3), generator=gen) * 2 - 1
    if mode == "unpadded":
        n_eff = torch.full((R,), N, dtype=torch.int32)
    else:
        n_eff = torch.randint(0, N, (R,), generator=gen, dtype=torch.int32)
        if mode == "zeros":
            n_eff[::3] = 0
    rows = torch.arange(N)[None, :]
    pts[rows > n_eff[:, None].long()] = 0.0
    return pts.to(device), n_eff.to(device)


def randomize_bn(model, gen):
    """Non-trivial BatchNorm state: bias in (0.1, 0.9), debiased mean
    N(0, 0.1), debiased variance U(0.5, 1.5), gamma U(0.8, 1.2)."""
    import torch

    from nestinet_tpu_torch.ops.nn import BatchNormEMA

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormEMA):
                c = m.ema_mean.shape[0]
                keep = 1.0 - (0.1 + 0.8 * torch.rand((), generator=gen))
                m.bias.fill_(1.0 - keep)
                m.ema_mean.copy_(torch.randn(c, generator=gen) * 0.1 * keep)
                m.ema_var.copy_((0.5 + torch.rand(c, generator=gen)) * keep)
                m.gamma.copy_(0.8 + 0.4 * torch.rand(c, generator=gen))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="GPU smoke test of the PyTorch port")
    parser.add_argument("--record", default=None,
                        help="also write every measured number to this JSON file")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nestinet_tpu_torch.core.device import resolve_device, set_f32_numerics

    dev = resolve_device("cuda")
    set_f32_numerics()
    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    record = {"gpu": card, "device_name": name, "torch": torch.__version__}

    # ---- 2. build ----
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.kernels import mups_cuda

    kernels = [mups_cuda.KERNEL]
    for k in kernels:
        t0 = time.perf_counter()
        path = k.build()
        k.lib()
        secs = time.perf_counter() - t0
        print(f"build: {k.name} -> {os.path.relpath(path)} in {secs:.2f} s", flush=True)
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        record[f"build_seconds_{k.name}"] = secs

    # ---- 3. kernel against its plain version, flagship shape ----
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    gmm = get_3d_grid_gmm([8, 8, 8], variance=0.0156)
    w, mu, sigma = (torch.from_numpy(a).to(dev) for a in gmm.astuple())
    gen = torch.Generator().manual_seed(SEED)
    R, N = 3 * BATCH, 512
    max_err = 0.0
    for mode in ("unpadded", "random", "zeros"):
        pts, n_eff = flagship_rows(gen, R, N, mode, dev)
        got = mups_cuda.tdmfv_n_est_cuda(pts, w, mu, sigma, n_eff)
        torch.cuda.synchronize()
        want = mups_ops.tdmfv_n_est_reference(pts, w, mu, sigma, n_eff)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"kernel output not finite ({mode})")
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        print(f"kernel vs plain [{mode}]: max abs err {err:.3e} (atol {KERNEL_ATOL})",
              flush=True)
        if not err <= KERNEL_ATOL:  # NaN fails too
            fail(f"MuPS kernel disagrees with its plain version ({mode}): {err}")
    record["kernel_max_abs_err"] = max_err

    # gradient through the autograd.Function at a small shape; unpadded,
    # because a statistic that is exactly 0 (a masked row's zero deciding a
    # max) has no derivative under the signed square root, in the
    # reference as here
    gmm3 = get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9)
    w3, mu3, s3 = (torch.from_numpy(a).to(dev) for a in gmm3.astuple())
    pts, n_eff = flagship_rows(gen, 8, 64, "unpadded", dev)
    weights = torch.arange(20.0, device=dev)[None, :, None]
    p1 = pts.clone().requires_grad_(True)
    (mups_ops.tdmfv_n_est(p1, w3, mu3, s3, n_eff) ** 2 * weights).sum().backward()
    p2 = pts.clone().requires_grad_(True)
    (mups_ops.tdmfv_n_est_reference(p2, w3, mu3, s3, n_eff) ** 2 * weights).sum().backward()
    torch.cuda.synchronize()
    gerr = (p1.grad - p2.grad).abs().max().item()
    print(f"kernel gradient vs plain: max abs err {gerr:.3e} (atol {GRAD_ATOL})", flush=True)
    if not gerr <= GRAD_ATOL:
        fail(f"gradient through the kernel's Function disagrees: {gerr}")

    # ---- 4. the slice, end to end ----
    from nestinet_tpu.core.config import Config
    from nestinet_tpu.core.rundir import RunDir
    from nestinet_tpu.data.loader import get_data_loader
    from nestinet_tpu.data.synthetic import build_protocol_benchmark
    from nestinet_tpu.eval.evaluate import evaluate_dataset
    from nestinet_tpu_torch.core import checkpoint
    from nestinet_tpu_torch.infer.predict import load_run, pad_batch, predict_shapes
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.models.base import init_params

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        build_protocol_benchmark(data, n_points=N_POINTS, n_pidx=500, seed=SEED % 1000)
        print(f"dataset: built in {time.perf_counter() - t0:.1f} s", flush=True)

        cfg = Config(model="experts_n_est", log_dir=os.path.join(tmp, "run"),
                     data_path=data, patch_radius=(0.01, 0.03, 0.05), num_point=512,
                     num_gaussians=8, n_experts=7, seed=SEED)
        rd = RunDir.create(cfg.log_dir)
        cfg.save(rd.config_path)
        run_gmm = get_3d_grid_gmm([8, 8, 8], variance=cfg.gmm_variance)
        run_gmm.save(rd.gmm_path)
        model = build_model(cfg, run_gmm)
        wgen = torch.Generator().manual_seed(SEED)
        init_params(model, wgen)
        randomize_bn(model, wgen)
        checkpoint.save(rd.path, model.state_dict())
        n_params = sum(v.numel() for v in model.state_dict().values())
        del model
        print(f"run dir: experts_n_est, {n_params} weights", flush=True)

        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        stats = predict_shapes(rd.path, dataset_name="pcpnet", testset="testset.txt",
                               data_path=data, batch_size=BATCH, loader_workers=8)
        launches = {k.name: k.launches for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"slice: {stats['n_patches']} patches in {stats['n_batches']} batches, "
              f"{stats['seconds']:.2f} s, {stats['patches_per_sec']:.1f} patches/s, "
              f"loader wait {stats['loader_wait_seconds']:.2f} s, peak {peak_gb:.2f} GB, "
              f"launches {launches} [{card}]", flush=True)
        for kname, count in launches.items():
            if count <= 0:
                fail(f"kernel {kname} was not launched on the main path")
        if launches["mups_kernel"] != stats["n_batches"]:
            fail(f"MuPS launches {launches['mups_kernel']} != batches {stats['n_batches']}")
        if "jax" in sys.modules:
            fail("jax was imported")

        out_dir = stats["output_dir"]
        with open(os.path.join(data, "testset.txt")) as f:
            shapes = [s.strip() for s in f if s.strip()]
        for shape in shapes:
            n_pts = np.loadtxt(os.path.join(data, shape + ".xyz")).shape[0]
            normals = np.loadtxt(os.path.join(out_dir, shape + ".normals"))
            experts = np.loadtxt(os.path.join(out_dir, shape + ".experts"))
            if normals.shape != (n_pts, 3) or not np.isfinite(normals).all():
                fail(f"{shape}.normals: shape {normals.shape} or non-finite values")
            if experts.shape != (n_pts,) or experts.min() < 0 or experts.max() >= 7:
                fail(f"{shape}.experts: bad shape or ids out of [0, 7)")
        summary = evaluate_dataset(data, out_dir, "testset", log=lambda *_: None)
        if not np.isfinite(summary["rms"]):
            fail("RMS is not finite")
        print(f"evaluate: testset RMS {summary['rms']:.4f} deg (random weights), "
              f"PGP10 {summary['pgp10']:.4f}", flush=True)

        # one batch: the kernel path against the same model on the plain MuPS
        _, _, _, model = load_run(rd.path, dev)
        loader, _ = get_data_loader(
            "testset.txt", indir=data, batch_size=BATCH, patch_radius=cfg.patch_radius,
            points_per_patch=cfg.num_point, outputs=(), seed=cfg.seed,
            patch_sample_order="full", workers=8,
        )
        batch = pad_batch(next(iter(loader)), BATCH)
        points = torch.from_numpy(batch["points"]).to(dev)
        n_eff = torch.from_numpy(batch["n_eff"].astype(np.int32)).to(dev)
        with torch.inference_mode():
            out_k = model(points, n_eff)
            plain_rows = mups_ops.tdmfv_n_est_reference(
                points.reshape(-1, cfg.num_point, 3), model.gmm_w, model.gmm_mu,
                model.gmm_sigma, n_eff.reshape(-1),
            )
            grid = mups_ops.stats_to_grid(plain_rows, BATCH, cfg.n_scales, model.resolution)
            out_p = model.forward_grid(grid)
            torch.cuda.synchronize()
            ids_k, _ = model.predict_experts(out_k)
            ids_p, _ = model.predict_experts(out_p)
            nrm_k, nrm_p = model.predict_normals(out_k), model.predict_normals(out_p)
        nerr = (nrm_k - nrm_p).abs().max().item()
        print(f"batch vs plain MuPS: ids equal {bool((ids_k == ids_p).all())}, normals max "
              f"abs err {nerr:.3e} (atol {NORMALS_ATOL}), max |normal| "
              f"{nrm_k.abs().max().item():.3f}", flush=True)
        if not bool((ids_k == ids_p).all()):
            fail("argmax expert ids differ between the kernel and the plain MuPS")
        if not nerr <= NORMALS_ATOL:
            fail(f"normals differ between the kernel and the plain MuPS: {nerr}")

        # ---- 5. times ----
        pts, n_eff_rows = flagship_rows(gen, R, N, "random", dev)
        k_ms = cuda_median_ms(lambda: mups_cuda.tdmfv_n_est_cuda(pts, w, mu, sigma, n_eff_rows))
        p_ms = cuda_median_ms(
            lambda: mups_ops.tdmfv_n_est_reference(pts, w, mu, sigma, n_eff_rows))
        with torch.inference_mode():
            fwd_ms = cuda_median_ms(lambda: model(points, n_eff), warmup=2, iters=10)
        print(f"time: MuPS kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per {R} rows "
              f"(N={N}, K=512); forward {fwd_ms:.3f} ms per batch of {BATCH} "
              f"({BATCH / fwd_ms * 1e3:.1f} patches/s device-bound) [{card}]", flush=True)

    record.update({
        "kernel_ms": k_ms, "plain_ms": p_ms, "forward_ms_b128": fwd_ms,
        "slice": {k: v for k, v in stats.items() if k not in ("shapes", "output_dir")},
        "peak_memory_gb": peak_gb, "launches": launches, "rms": summary["rms"],
        "batch_normals_max_abs_err": nerr,
    })
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=2)

    print(json.dumps({"kernels": [{
        "name": "tdmfv_n_est",
        "route": "cuda",
        "source": "nestinet_tpu_torch/csrc/mups_kernel.cu",
        "replaces": "nestinet_tpu/ops/pallas/mups_kernel.py:43",
        "launches": launches["mups_kernel"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
