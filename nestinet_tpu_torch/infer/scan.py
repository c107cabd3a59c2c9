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
import struct
import tempfile
import time
import zlib

import numpy as np
import torch

from ..core import textio
from ..data.depth import depth_to_xyz, world_to_image
from .predict import predict_shapes

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes with its PNG filter undone (PNG spec, section
    9); `prior` is the row above, already unfiltered (zeros for the first)."""
    if kind == 0:  # None
        return row
    if kind == 1:  # Sub: a running sum per byte lane of a pixel, mod 256
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:  # Up
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {kind}")
    out, up = row.tolist(), prior.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:  # Average
            pred = (a + b) >> 1
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def read_png_gray(path: str) -> np.ndarray:
    """[H, W] pixel values of a non-interlaced grayscale PNG of bit depth
    8 (uint8) or 16 (uint16, big-endian in the file); any other PNG kind
    raises ValueError, as does a chunk whose CRC does not match."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    if color != 0 or depth not in (8, 16) or interlace != 0:
        raise ValueError(
            f"{path}: only non-interlaced grayscale PNGs of 8 or 16 bits are read "
            f"(this one: color type {color}, bit depth {depth}, interlace {interlace})"
        )
    bpp = depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {height} rows")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    pixels = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = pixels[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16)
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
