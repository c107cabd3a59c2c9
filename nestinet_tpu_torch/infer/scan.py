"""Real-scan streaming inference: depth image -> world xyz -> per-point
normals -> optional normal-map image.

Counterpart of `nestinet_tpu/infer/scan.py`.  The reference handled real
scans (ScanNet / NYU-v2) with offline MATLAB pre/post-processing around
`test_n_est_w_experts.py` (`MATLAB/ScanNet_depth2xyz.m`,
`MATLAB/ScanNet_world2cam_normals.m`, `utils/nyu_test_all.py`); here the
whole chain is one call or one CLI.  The unprojected cloud is staged as a
one-shape dataset through the port's `core/textio.py` and served whole by
the port's host `predict_shapes` (kd-tree extraction, argmax routing, the
run's dtype).

`load_depth` reads `.npy`, `.npz`, `.txt` and, without PIL, grayscale
8- and 16-bit PNG (ScanNet's depth format) and binary PGM.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from ..core import textio
from ..data.depth import depth_to_xyz, world_to_image
from ..viz.png import read_png
from .predict import predict_shapes


def read_png_gray(path: str) -> np.ndarray:
    """[H, W] pixel values of a non-interlaced grayscale PNG of bit depth
    8 (uint8) or 16 (uint16, big-endian in the file), read by
    `viz/png.py::read_png`; any other PNG kind raises ValueError, as does a
    chunk whose CRC does not match."""
    pixels = read_png(path)
    if pixels.ndim != 2:
        raise ValueError(f"{path}: only grayscale PNGs are read as depth "
                         f"(this one has {pixels.shape[2]} channels)")
    return pixels


def read_pgm(path: str) -> np.ndarray:
    """[H, W] pixel values of a binary (P5) PGM: uint8 for a maxval below
    256, else big-endian uint16."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    if tokens[0] != b"P5":
        raise ValueError(f"{path}: only binary (P5) PGM files are read")
    width, height, maxval = (int(t) for t in tokens[1:])
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    body = data[pos + 1:pos + 1 + width * height * np.dtype(dtype).itemsize]
    return np.frombuffer(body, dtype).reshape(height, width).astype(
        np.uint8 if maxval < 256 else np.uint16)


def load_depth(path: str, depth_shift: float = 1000.0) -> np.ndarray:
    """Load a depth image: .npy/.npz (raw values), grayscale .png/.pgm
    (raw values as float64, e.g. millimeters), or whitespace .txt.
    `depth_shift` is unused, as in the JAX package: `predict_scan` divides."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".npy",):
        return np.load(path)
    if ext in (".npz",):
        z = np.load(path)
        return z[list(z.files)[0]]
    if ext == ".png":
        return read_png_gray(path).astype(np.float64)
    if ext == ".pgm":
        return read_pgm(path).astype(np.float64)
    return np.loadtxt(path)


def predict_scan(
    run_dir: str,
    depth_img: np.ndarray,
    intrinsic: np.ndarray,
    pose: np.ndarray | None = None,
    *,
    depth_shift: float = 1.0,
    batch_size: int = 128,
    loader_workers: int = 8,
    output_dir: str | None = None,
    scan_name: str = "scan",
    moe_inference: str = "sparse",
    project_to_image: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Depth map -> world points -> normals (+ optional image render).

    Returns the predict_shapes stats dict extended with:
        points:        [M, 3] the unprojected world points
        normals_path:  the written .normals file
        normal_image:  [H, W, 3] when project_to_image (also saved .npy)
        stage_seconds: wall seconds of depth_to_xyz, staging (the .xyz
                       write), serving (predict_shapes) and projection
    """
    if pose is None:
        pose = np.eye(4)
    t0 = time.perf_counter()
    points = depth_to_xyz(depth_img, intrinsic, pose, depth_shift=depth_shift)
    if points.shape[0] == 0:
        raise ValueError("depth image produced no valid points")
    seconds = {"depth_to_xyz": time.perf_counter() - t0}

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        textio.savetxt(
            os.path.join(tmp, scan_name + ".xyz"),
            points.astype(np.float64),
        )
        with open(os.path.join(tmp, "scanset.txt"), "w") as f:
            f.write(scan_name + "\n")
        seconds["staging"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = predict_shapes(
            run_dir,
            dataset_name=scan_name,
            testset="scanset.txt",
            data_path=tmp,
            batch_size=batch_size,
            loader_workers=loader_workers,
            output_dir=output_dir,
            moe_inference=moe_inference,
            device=device,
        )
        seconds["serving"] = time.perf_counter() - t0

    normals_path = os.path.join(stats["output_dir"], scan_name + ".normals")
    stats["points"] = points
    stats["normals_path"] = normals_path
    if project_to_image:
        t0 = time.perf_counter()
        normals = np.loadtxt(normals_path)
        norm = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.where(norm == 0, 1.0, norm)
        img = world_to_image(
            points, normals, depth_img.shape, intrinsic, pose
        )
        img_path = os.path.join(stats["output_dir"], scan_name + "_normals_img.npy")
        np.save(img_path, img)
        stats["normal_image"] = img
        stats["normal_image_path"] = img_path
        seconds["projection"] = time.perf_counter() - t0
    stats["stage_seconds"] = seconds
    return stats
