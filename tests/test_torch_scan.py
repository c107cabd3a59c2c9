"""The port's real-scan path against the JAX package's, on the CPU.

  * `data/depth.py`: `depth_to_xyz` and `world_to_image` give the same
    arrays as JAX's on one seeded depth image, intrinsic and pose, with
    and without `apply_translation`, and with points that collide on a
    pixel (the last write wins in both, in the points' order);
  * `load_depth`: `.npy`, `.npz`, `.txt`, and 8- and 16-bit grayscale PNG
    (written by PIL, and by hand with each of the five filter types) and
    PGM read as JAX's (PIL) reads them; other PNG kinds and a corrupt chunk
    raise ValueError;
  * `predict_scan` and `cli.scan` on one tiny-backbone `experts_n_est` run
    dir that only the JAX package wrote (as in `tests/test_scan.py:19-41`,
    the manager's logits spread so that patches route to several experts),
    served by both packages in float32 on a 24 x 32 depth frame with holes
    and a rotated, translated pose: `.normals` within atol 1e-4, `.experts`
    identical, the normal image within atol 1e-4 with the same zero mask.
"""

import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from nestinet_tpu.cli import scan as jax_cli_scan
from nestinet_tpu.data import depth as jax_depth
from nestinet_tpu.infer.scan import load_depth as jax_load_depth
from nestinet_tpu.infer.scan import predict_scan as jax_predict_scan
from nestinet_tpu_torch.cli import scan as cli_scan
from nestinet_tpu_torch.data import depth
from nestinet_tpu_torch.infer.scan import load_depth, predict_scan

from .test_torch_slice import build_data, build_run

torch.set_num_threads(1)

H, W = 24, 32


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def scene(seed=0, h=H, w=W):
    """(depth [h, w] with ~10% holes, 3x3 intrinsic, 4x4 pose with a
    rotation and a translation)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    d = 1.5 + 0.02 * xx + 0.01 * yy + 0.05 * rng.rand(h, w)
    d[rng.rand(h, w) < 0.1] = 0.0
    d[:3, :3] = 0.0
    intrinsic = np.array([[20.0, 0, w / 2 - 0.5], [0, 21.0, h / 2 - 0.5], [0, 0, 1.0]])
    pose = np.eye(4)
    pose[:3, :3] = _rotation(rng)
    pose[:3, 3] = rng.uniform(-1, 1, 3)
    return d, intrinsic, pose


@pytest.mark.parametrize("apply_translation", [False, True])
@pytest.mark.parametrize("intrinsic_4x4", [False, True])
def test_depth_to_xyz_equals_jax(apply_translation, intrinsic_4x4):
    d, intrinsic, pose = scene(1)
    d = np.round(d * 1000)  # millimetres
    if intrinsic_4x4:
        k4 = np.eye(4)
        k4[:3, :3] = intrinsic
        intrinsic = k4
    kw = dict(depth_shift=1000.0, apply_translation=apply_translation)
    got = depth.depth_to_xyz(d, intrinsic, pose, **kw)
    want = jax_depth.depth_to_xyz(d, intrinsic, pose, **kw)
    assert got.shape == (int((d != 0).sum()), 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("apply_translation", [False, True])
def test_world_to_image_equals_jax(apply_translation):
    """Every point projected back, most of them onto a pixel another point
    also hits: each colliding pixel holds one point's property, the same
    in both packages (NumPy's fancy assignment in the points' order)."""
    d, intrinsic, pose = scene(2)
    points = depth.depth_to_xyz(d, intrinsic, pose, apply_translation=apply_translation)
    rng = np.random.RandomState(3)
    # the same points again, moved by under half a pixel, in reverse order,
    # and a few far outside the frame
    moved = points[::-1] * (1.0 + rng.uniform(-1e-3, 1e-3, (points.shape[0], 1)))
    far = rng.uniform(-50, 50, (20, 3))
    cloud = np.concatenate([points, moved, far])
    prop = rng.normal(size=(cloud.shape[0], 3)).astype(np.float32)
    got = depth.world_to_image(cloud, prop, (H, W), intrinsic, pose)
    want = jax_depth.world_to_image(cloud, prop, (H, W), intrinsic, pose)
    assert got.dtype == want.dtype and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    hits = np.zeros((H, W), int)
    pix = intrinsic @ (np.linalg.inv(pose) @ np.c_[cloud, np.ones(len(cloud))].T)[:3]
    x, y = np.floor(pix[:2] / pix[2] + 0.5).astype(int)
    ok = (x > 0) & (y > 0) & (x <= W) & (y <= H)
    np.add.at(hits, (y[ok] - 1, x[ok] - 1), 1)
    assert (hits > 1).sum() > 0.3 * (hits > 0).sum()  # collisions are exercised


# ---- load_depth ----

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _filter_row(kind, row, prior, bpp):
    """PNG's forward filter of one row of bytes (int arrays)."""
    left = np.concatenate([np.zeros(bpp, int), row[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, int), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) >> 1
    else:
        p = left + prior - up_left
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
    return (row - pred) & 0xFF


def write_png(path, img, filters=(0, 1, 2, 3, 4), color=0, interlace=0):
    """A grayscale PNG of uint8 or uint16 pixels, row y filtered with
    filters[y % len(filters)]; `color` and `interlace` only go into IHDR."""
    h, w = img.shape
    depth_bits = 8 * img.dtype.itemsize
    bpp = img.dtype.itemsize
    raw = np.frombuffer(img.astype(img.dtype.newbyteorder(">")).tobytes(),
                        np.uint8).reshape(h, w * bpp).astype(int)
    out, prior = bytearray(), np.zeros(w * bpp, int)
    for y in range(h):
        kind = filters[y % len(filters)]
        out.append(kind)
        out += bytes(_filter_row(kind, raw[y], prior, bpp).astype(np.uint8))
        prior = raw[y]
    ihdr = struct.pack(">IIBBBBB", w, h, depth_bits, color, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(b"IEND", b""))


def _pixels(dtype, seed=4):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:19, :23]
    top = np.iinfo(dtype).max
    img = (top * (0.3 + 0.01 * xx + 0.005 * yy) + rng.randint(0, 40, (19, 23))) % (top + 1)
    img[rng.rand(19, 23) < 0.1] = 0
    return img.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("writer", ["pil_png", "pil_pgm", "filter0", "filter1", "filter2",
                                    "filter3", "filter4", "all_filters"])
def test_load_depth_reads_images_as_jax(tmp_path, dtype, writer):
    from PIL import Image

    img = _pixels(dtype)
    if writer == "pil_pgm":
        path = str(tmp_path / "d.pgm")
        Image.fromarray(img).save(path)
    elif writer == "pil_png":
        path = str(tmp_path / "d.png")
        Image.fromarray(img).save(path)
    else:
        path = str(tmp_path / "d.png")
        filters = (0, 1, 2, 3, 4) if writer == "all_filters" else (int(writer[-1]),)
        write_png(path, img, filters)
    got, want = load_depth(path), jax_load_depth(path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("ext", [".npy", ".npz", ".txt"])
def test_load_depth_reads_arrays_as_jax(tmp_path, ext):
    d, _, _ = scene(5)
    path = str(tmp_path / ("d" + ext))
    {".npy": lambda: np.save(path, d), ".npz": lambda: np.savez(path, depth=d),
     ".txt": lambda: np.savetxt(path, d)}[ext]()
    got, want = load_depth(path), jax_load_depth(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb", "palette", "gray_alpha", "one_bit", "interlaced",
                                  "bad_crc", "not_png"])
def test_load_depth_refuses_other_pngs(tmp_path, kind):
    from PIL import Image

    path = str(tmp_path / "d.png")
    img = _pixels(np.uint8)
    if kind == "rgb":
        Image.fromarray(np.stack([img] * 3, -1)).save(path)
    elif kind == "palette":
        Image.fromarray(img).convert("P").save(path)
    elif kind == "gray_alpha":
        Image.fromarray(img).convert("LA").save(path)
    elif kind == "one_bit":
        Image.fromarray(img).convert("1").save(path)
    elif kind == "interlaced":
        write_png(path, img, interlace=1)
    elif kind == "bad_crc":
        write_png(path, img)
        data = bytearray(open(path, "rb").read())
        data[40] ^= 0xFF  # inside IDAT
        open(path, "wb").write(bytes(data))
    else:
        open(path, "wb").write(img.tobytes())
    with pytest.raises(ValueError):
        load_depth(path)


# ---- predict_scan and cli.scan, both packages on one JAX run dir ----

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny-backbone `experts_n_est` run dir holding only the JAX
    trainer's checkpoint (the port reads it with its msgpack reader)."""
    root = str(tmp_path_factory.mktemp("torch_scan"))
    run = build_run(root, build_data(root))
    shutil.rmtree(os.path.join(run, "ckpt_torch"))
    return root, run


@pytest.fixture(scope="module")
def scanned(jax_run):
    root, run = jax_run
    d, intrinsic, pose = scene(6)
    common = dict(depth_shift=1.0, batch_size=64, loader_workers=2, project_to_image=True)
    want = jax_predict_scan(run, d, intrinsic, pose, output_dir=os.path.join(root, "jax"),
                            **common)
    got = predict_scan(run, d, intrinsic, pose, output_dir=os.path.join(root, "port"),
                       device="cpu", **common)
    return d, want, got


def _compare_outputs(want_dir, got_dir, name, want_img, got_img):
    load = lambda d, ext: np.loadtxt(os.path.join(d, name + ext))  # noqa: E731
    np.testing.assert_allclose(load(got_dir, ".normals"), load(want_dir, ".normals"),
                               atol=1e-4, rtol=0)
    ids = load(got_dir, ".experts")
    np.testing.assert_array_equal(ids, load(want_dir, ".experts"))
    assert len(np.unique(ids)) > 1  # the routing is exercised
    np.testing.assert_array_equal(got_img != 0, want_img != 0)
    np.testing.assert_allclose(got_img, want_img, atol=1e-4, rtol=0)


def test_predict_scan_equals_jax(scanned):
    d, want, got = scanned
    n = int((d != 0).sum())
    assert got["points"].shape == (n, 3) and got["n_patches"] == want["n_patches"] == n
    np.testing.assert_array_equal(got["points"], want["points"])
    assert got["device"] == "cpu" and got["compute_dtype"] == "float32"
    # every stats key of JAX's but its router's FIFO counters (not ported)
    assert set(want) - {"window_slots", "forced_flushes"} <= set(got)
    assert set(got["stage_seconds"]) == {"depth_to_xyz", "staging", "serving", "projection"}
    img = got["normal_image"]
    assert img.shape == (H, W, 3)
    np.testing.assert_array_equal(np.load(got["normal_image_path"]), img)
    _compare_outputs(want["output_dir"], got["output_dir"], "scan", want["normal_image"], img)
    filled = np.any(img != 0, axis=-1)
    assert not filled[:3, :3].any() and filled.sum() > 0.6 * n


def test_cli_scan_equals_jax(jax_run, tmp_path, capsys):
    """Both CLIs on the same files: a 16-bit millimetre PNG, a 4x4
    intrinsic and the pose as text."""
    from PIL import Image

    _, run = jax_run
    d, intrinsic, pose = scene(7)
    png = str(tmp_path / "depth.png")
    Image.fromarray(np.round(d * 1000).astype(np.uint16)).save(png)
    k4 = np.eye(4)
    k4[:3, :3] = intrinsic
    np.savetxt(tmp_path / "intrinsic.txt", k4)
    np.save(tmp_path / "pose.npy", pose)
    args = ["--results_path", run, "--depth", png, "--intrinsic",
            str(tmp_path / "intrinsic.txt"), "--pose", str(tmp_path / "pose.npy"),
            "--depth_shift", "1000", "--batch_size", "64", "--loader_workers", "2",
            "--project_to_image", "1", "--scan_name", "frame"]
    outs = {}
    for name, main, extra in (("jax", jax_cli_scan.main, []),
                              ("port", cli_scan.main, ["--device", "cpu"])):
        capsys.readouterr()
        main(args + ["--output_dir", str(tmp_path / name)] + extra)
        outs[name] = json.loads(capsys.readouterr().out)
    want, got = outs["jax"], outs["port"]
    assert set(got) == set(want)
    assert got["n_points"] == want["n_points"] == got["n_patches"] == int((d != 0).sum())
    _compare_outputs(str(tmp_path / "jax"), str(tmp_path / "port"), "frame",
                     np.load(want["normal_image_path"]), np.load(got["normal_image_path"]))
