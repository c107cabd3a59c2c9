"""The port's copies of the numpy-only host library against the JAX
package's: `data/ply.py`, `data/pointcloud.py`, `data/modelnet.py`, the
augmentations of `data/augment.py` and the conversions of
`data/rotations.py`.  The same seeded inputs (and the same RandomState for
the random helpers) give identical arrays; PLY files written by either
package are byte-identical, in ascii and binary, and each package reads
the other's; an `.h5` file written here loads alike.
"""

import sys
import unittest.mock as mock

import numpy as np
import pytest

from nestinet_tpu.data import augment as jax_augment
from nestinet_tpu.data import modelnet as jax_modelnet
from nestinet_tpu.data import ply as jax_ply
from nestinet_tpu.data import pointcloud as jax_pointcloud
from nestinet_tpu.data import rotations as jax_rotations
from nestinet_tpu.ops.gmm import get_3d_grid_gmm as jax_grid_gmm
from nestinet_tpu_torch.data import augment, modelnet, ply, pointcloud, rotations
from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401


def assert_same(got, want):
    """Equal structure and values, arrays bit for bit (NaN at the same places)."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_same(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- rotations


ANGLES = [(0.0, 0.0, 0.0), (0.3, -1.1, 2.5), (-2.9, np.pi / 2, 0.4), (1.0, 0.0, -0.7)]


@pytest.mark.parametrize("angles", ANGLES)
def test_rotations_equal_jax(angles):
    z, y, x = angles
    for name in ("euler2mat", "euler2quat", "euler2angle_axis"):
        assert_same(getattr(rotations, name)(z, y, x), getattr(jax_rotations, name)(z, y, x))
    m, q = jax_rotations.euler2mat(z, y, x), jax_rotations.euler2quat(z, y, x)
    for name, arg in (("mat2euler", m), ("mat2quat", m), ("quat2mat", q), ("quat2euler", q)):
        assert_same(getattr(rotations, name)(arg), getattr(jax_rotations, name)(arg))
    theta, axis = jax_rotations.euler2angle_axis(z, y, x)
    for normalized in (False, True):
        assert_same(rotations.angle_axis2euler(theta, axis, normalized),
                    jax_rotations.angle_axis2euler(theta, axis, normalized))
    assert_same(rotations.angle_axis2euler(0.4, [0, 0, 0]),
                jax_rotations.angle_axis2euler(0.4, [0, 0, 0]))
    assert_same(rotations.quat2mat([0, 0, 0, 0]), jax_rotations.quat2mat([0, 0, 0, 0]))
    assert_same(rotations.random_rotation(np.random.RandomState(5)),
                jax_rotations.random_rotation(np.random.RandomState(5)))


# ---------------------------------------------------------------- augment


def clouds(seed=0, b=3, n=64):
    return np.random.RandomState(seed).uniform(-1, 1, (b, n, 3)).astype(np.float32)


AUGMENT_CASES = {
    "rotate_y": lambda m, pc, rng: m.rotate_y(pc, rng),
    "rotate_y_by_angle": lambda m, pc, rng: m.rotate_y_by_angle(pc, 0.7),
    "rotate_x_by_angle": lambda m, pc, rng: m.rotate_x_by_angle(pc, -1.3),
    "translate": lambda m, pc, rng: m.translate(pc, rng, 0.3),
    "anisotropic_scale": lambda m, pc, rng: m.anisotropic_scale(pc, rng),
    "jitter": lambda m, pc, rng: m.jitter(pc, rng, sigma=0.05, clip=0.02),
    "insert_outliers": lambda m, pc, rng: m.insert_outliers(pc, rng, 0.1),
    "occlude": lambda m, pc, rng: m.occlude(pc, rng, 0.2),
    "rotate_patches_and_normals": lambda m, pc, rng: m.rotate_patches_and_normals(
        pc, pc[:, 0], rng),
}


@pytest.mark.parametrize("case", sorted(AUGMENT_CASES))
def test_augmentations_equal_jax(case):
    fn = AUGMENT_CASES[case]
    got = fn(augment, clouds(), np.random.RandomState(9))
    want = fn(jax_augment, clouds(), np.random.RandomState(9))
    assert_same(got, want)


def test_starve_gaussians_equals_jax():
    pc = clouds(2, n=200)
    got = augment.starve_gaussians(pc, get_3d_grid_gmm([3, 3, 3], 1.0 / 9),
                                   np.random.RandomState(4), n_points=120)
    want = jax_augment.starve_gaussians(pc, jax_grid_gmm([3, 3, 3], 1.0 / 9),
                                        np.random.RandomState(4), n_points=120)
    assert got.shape == (3, 120, 3)
    assert_same(got, want)


# ---------------------------------------------------------------- pointcloud


def test_pointcloud_helpers_equal_jax():
    pc = clouds(3)
    for name, args in (("point_cloud_to_volume", (pc[0], 8, 1.0)),
                       ("point_cloud_to_volume_batch", (pc, 6)),
                       ("point_cloud_three_views", (pc[1], 32))):
        assert_same(getattr(pointcloud, name)(*args), getattr(jax_pointcloud, name)(*args))
    batch = jax_pointcloud.point_cloud_to_volume_batch(pc, 6, flatten=False)
    assert_same(pointcloud.point_cloud_to_volume_batch(pc, 6, flatten=False), batch)
    vol = jax_pointcloud.point_cloud_to_volume(pc[2], 8)
    assert_same(pointcloud.volume_to_point_cloud(vol), jax_pointcloud.volume_to_point_cloud(vol))


# ---------------------------------------------------------------- ply


def ply_elements(seed):
    rng = np.random.RandomState(seed)
    n, f = 17, 5
    return {
        "vertex": {"x": rng.randn(n).astype(np.float32), "y": rng.randn(n).astype(np.float32),
                   "z": rng.randn(n).astype(np.float64),
                   "red": rng.randint(0, 255, n).astype(np.uint8)},
        "face": {"vertex_indices": rng.randint(0, n, (f, 3)).astype(np.int32),
                 "flags": rng.randint(-5, 5, f).astype(np.int16),
                 "uv": [list(rng.randint(0, 9, k)) for k in rng.randint(1, 5, f)]},
    }


@pytest.mark.parametrize("binary", [False, True])
def test_ply_files_are_byte_identical_and_cross_read(tmp_path, binary):
    rng = np.random.RandomState(1)
    pts, nrm = rng.randn(40, 3).astype(np.float32), rng.randn(40, 3).astype(np.float32)
    faces = rng.randint(0, 40, (12, 3))
    for name, write in (("points", lambda m, p: m.write_ply(p, pts, normals=nrm, faces=faces,
                                                            binary=binary)),
                        ("elements", lambda m, p: m.write_ply_elements(p, ply_elements(2),
                                                                       binary=binary))):
        ours, theirs = str(tmp_path / f"{name}_port.ply"), str(tmp_path / f"{name}_jax.ply")
        write(ply, ours)
        write(jax_ply, theirs)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), name
        assert_same(ply.read_ply(theirs), jax_ply.read_ply(theirs))
        assert_same(jax_ply.read_ply(ours), ply.read_ply(ours))
        assert_same(ply.read_ply_points(theirs), jax_ply.read_ply_points(ours))
    # ascii prints what both packages print; binary keeps every bit
    np.testing.assert_allclose(ply.read_ply_points(str(tmp_path / "points_jax.ply")), pts,
                               atol=0 if binary else 1e-6, rtol=0)


# ---------------------------------------------------------------- modelnet


def test_modelnet_loads_alike(tmp_path):
    import h5py

    rng = np.random.RandomState(6)
    data = rng.randn(10, 32, 3).astype(np.float32)
    label = rng.randint(0, 40, (10, 1)).astype(np.uint8)
    path = str(tmp_path / "ply_data_train0.h5")
    with h5py.File(path, "w") as f:
        f["data"], f["label"] = data, label
        f["normal"] = rng.randn(10, 32, 3).astype(np.float32)
        f["pid"] = rng.randint(0, 50, (10, 32)).astype(np.uint8)
    for name in ("load_h5", "load_h5_with_normals", "load_h5_with_seg"):
        assert_same(getattr(modelnet, name)(path), getattr(jax_modelnet, name)(path))
    with open(tmp_path / "train_files.txt", "w") as f:
        f.write("ply_data_train0.h5\n\n" + path + "\n")
    files = str(tmp_path / "train_files.txt")
    assert modelnet.get_data_files(files) == jax_modelnet.get_data_files(files) == [path] * 2
    assert_same(modelnet.shuffle_data(data, label, seed=3),
                jax_modelnet.shuffle_data(data, label, seed=3))
    for kw in (dict(seed=2), dict(shuffle=False, drop_last=False)):
        assert_same(list(modelnet.iter_batches(data, label, 4, **kw)),
                    list(jax_modelnet.iter_batches(data, label, 4, **kw)))


def test_modelnet_without_h5py_names_it(tmp_path):
    """Once a test that the loaders raised ImportError naming h5py: they
    now read HDF5 without it (`data/h5.py`) and equal JAX's loaders, which
    read through h5py (the name is kept from then)."""
    import h5py

    rng = np.random.RandomState(12)
    path = str(tmp_path / "ply_data_test0.h5")
    with h5py.File(path, "w") as f:  # PointNet's save_h5 settings
        f.create_dataset("data", data=rng.randn(6, 64, 3).astype(np.float32),
                         compression="gzip", compression_opts=4)
        f.create_dataset("label", data=rng.randint(0, 40, (6, 1)).astype(np.uint8),
                         compression="gzip", compression_opts=1)
        f.create_dataset("normal", data=rng.randn(6, 64, 3).astype(np.float32),
                         compression="gzip", compression_opts=4)
        f.create_dataset("pid", data=rng.randint(0, 50, (6, 64)).astype(np.uint8),
                         compression="gzip", compression_opts=1)
    names = ("load_h5", "load_h5_with_normals", "load_h5_with_seg")
    want = {name: getattr(jax_modelnet, name)(path) for name in names}
    with mock.patch.dict(sys.modules, {"h5py": None}):
        for name in names:
            got = getattr(modelnet, name)(path)
            assert [a.dtype for a in got] == [b.dtype for b in want[name]]
            assert_same(got, want[name])
