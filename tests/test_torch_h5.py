"""The port's HDF5 reader (`data/h5.py`, NumPy and zlib) against h5py.

Each writer case writes a file with h5py in `tmp_path` and reads every
dataset of it with both h5py and the port: `np.array_equal` and equal
dtypes.  The cases: PointNet's `save_h5` settings (gzip 4 on `data`, gzip 1
on `label`; float32 data as ModelNet40's, and uint8 as its defaults),
contiguous, compact, shuffle + gzip, five dtypes in both byte orders, a
chunk shape that does not divide the shape, datasets created with a shape
only (the fill value; chunked ones partly written), a nested group, more
than 8 datasets in one group (the group's B-tree splits over several
symbol-table nodes), more than 64 chunks (the chunk B-tree has two
levels), scalars, and a user block before the superblock.  h5py cannot
write superblock version 1 (a non-default chunk B-tree K), so that path is
not run.  `libver="latest"`,
fletcher32, lzf and a variable-length string raise NotImplementedError
naming the feature.

The committed fixture `nestinet_tpu_torch/testdata/modelnet_h5/` holds two
files written with PointNet's settings (`ply_data_train0.h5`: data
float32 [8, 512, 3], label uint8 [8, 1], normal float32 [8, 512, 3];
`ply_data_seg0.h5`: data, label and pid uint8 [8, 512]), their
`files.txt` manifest and `expected.npz`.  Rewrite it with

    python -m tests.test_torch_h5 --write
"""

import argparse
import os
import sys
from unittest import mock

import h5py
import numpy as np
import pytest

from nestinet_tpu.data import modelnet as jax_modelnet
from nestinet_tpu_torch.data import h5, modelnet
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "nestinet_tpu_torch", "testdata", "modelnet_h5")


def save_h5(path, data, label, extra_name=None, extra=None, extra_gzip=4):
    """PointNet's `data_prep_util.save_h5` (and its `_data_label_normal`
    variant): `data` gzip 4, `label` gzip 1, one more set beside them."""
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, compression="gzip", compression_opts=4,
                         dtype=data.dtype)
        f.create_dataset("label", data=label, compression="gzip", compression_opts=1,
                         dtype=label.dtype)
        if extra_name:
            f.create_dataset(extra_name, data=extra, compression="gzip",
                             compression_opts=extra_gzip, dtype=extra.dtype)


def _compact(f, name, arr):
    """A dataset of compact layout (h5py's high-level API has none)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple(arr.shape)
    ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(arr.dtype), space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)


_rng = np.random.RandomState(8)


def _case_pointnet(f):
    save_h5(f, _rng.randn(4, 256, 3).astype(np.float32),
            _rng.randint(0, 40, (4, 1)).astype(np.uint8))


def _case_pointnet_uint8(f):
    """`save_h5` at its own default dtypes, uint8 both."""
    save_h5(f, _rng.randint(0, 256, (5, 100, 3)).astype(np.uint8),
            _rng.randint(0, 40, (5, 1)).astype(np.uint8))


def _case_contiguous(f):
    with h5py.File(f, "w") as h:
        h["a"] = _rng.randn(17, 5)
        h["b"] = _rng.randint(-9, 9, 31).astype(np.int16)


def _case_compact(f):
    with h5py.File(f, "w") as h:
        _compact(h, "c", _rng.randint(0, 1000, (6, 4)).astype(np.int32))
        _compact(h, "d", _rng.randn(5).astype(">f8"))


def _case_shuffle_gzip(f):
    with h5py.File(f, "w") as h:
        h.create_dataset("s", data=_rng.randint(0, 1 << 20, (40, 9)).astype(np.int32),
                         shuffle=True, compression="gzip", chunks=(8, 9))
        h.create_dataset("t", data=_rng.randn(33).astype(np.float64), shuffle=True,
                         compression="gzip", compression_opts=9, chunks=(5,))


def _dtype_case(dtype, order):
    def write(f):
        dt = np.dtype(dtype).newbyteorder(order)
        vals = _rng.randn(12, 7) * 50 if dt.kind == "f" else _rng.randint(0, 120, (12, 7))
        with h5py.File(f, "w") as h:
            h.create_dataset("contiguous", data=vals.astype(dt))
            h.create_dataset("chunked", data=vals.astype(dt), chunks=(5, 3),
                             compression="gzip")
    return write


def _case_edge_chunks(f):
    with h5py.File(f, "w") as h:
        h.create_dataset("e", data=_rng.randn(10, 7, 3).astype(np.float32),
                         chunks=(4, 3, 2), compression="gzip")


def _case_fill(f):
    with h5py.File(f, "w") as h:
        h.create_dataset("contiguous", shape=(3, 4), dtype="f8", fillvalue=2.5)
        h.create_dataset("default", shape=(5,), dtype="i4")
        part = h.create_dataset("partial", shape=(20, 6), dtype="i2", chunks=(4, 3),
                                fillvalue=-7, compression="gzip")
        part[5:9, 2:5] = 11  # four of the ten chunks allocated


def _case_nested(f):
    with h5py.File(f, "w") as h:
        h.create_group("a/b/c")["x"] = np.arange(5, dtype=np.uint16)
        h["a/y"] = np.arange(3.0)


def _case_many_datasets(f):
    with h5py.File(f, "w") as h:
        for i in range(40):
            h[f"set{i:02d}"] = np.full((2, i % 3 + 1), i, np.int64)


def _case_many_chunks(f):
    with h5py.File(f, "w") as h:
        h.create_dataset("m", data=np.arange(300 * 4).reshape(300, 4), chunks=(2, 4),
                         compression="gzip")


def _case_scalar(f):
    with h5py.File(f, "w") as h:
        h["s"] = 3.5
        h["i"] = np.int8(-4)


def _case_user_block(f):
    """512 bytes before the superblock: addresses count from it."""
    with h5py.File(f, "w", userblock_size=512) as h:
        h.create_dataset("v", data=np.arange(400.0).reshape(100, 4), chunks=(8, 4),
                         compression="gzip")
        h["w"] = np.arange(7, dtype=np.int16)


CASES = {
    "pointnet": _case_pointnet,
    "pointnet_uint8": _case_pointnet_uint8,
    "contiguous": _case_contiguous,
    "compact": _case_compact,
    "shuffle_gzip": _case_shuffle_gzip,
    "edge_chunks": _case_edge_chunks,
    "fill_value": _case_fill,
    "nested_group": _case_nested,
    "many_datasets": _case_many_datasets,
    "many_chunks": _case_many_chunks,
    "scalar": _case_scalar,
    "user_block": _case_user_block,
    **{f"{dt}_{'le' if o == '<' else 'be'}": _dtype_case(dt, o)
       for dt in ("float32", "float64", "uint8", "int32", "int64") for o in "<>"},
}


def _datasets(group, prefix=""):
    for name in group.keys():
        obj = group[name]
        if isinstance(obj, h5py.Group):
            yield from _datasets(obj, f"{prefix}{name}/")
        else:
            yield prefix + name


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_what_h5py_wrote(case, tmp_path):
    path = str(tmp_path / f"{case}.h5")
    CASES[case](path)
    with h5py.File(path, "r") as want, h5.File(path) as got:
        names = list(_datasets(want))
        assert names
        for name in names:
            a, b = want[name][()], got[name][()]
            assert b.dtype == a.dtype, name
            assert np.array_equal(a, b), name
            assert got[name].shape == a.shape
        assert sorted(got.keys()) == sorted(want.keys())


def test_the_b_trees_span_several_nodes(tmp_path):
    """The many-datasets and many-chunks cases reach what they are for: a
    group whose B-tree points at several symbol-table nodes, and a chunk
    B-tree of two levels."""
    path = str(tmp_path / "m.h5")
    _case_many_datasets(path)
    with h5.File(path) as f:
        _, used, _ = h5._btree_node(f._r, f._btree, 0, "/")
        assert used > 1 and len(f.keys()) == 40
    _case_many_chunks(path)
    with h5.File(path) as f:
        layout = f["m"]._layout
        level, _, _ = h5._btree_node(f._r, int.from_bytes(layout[3:11], "little"), 1, "m")
        assert level == 1


@pytest.mark.parametrize("feature", ["libver_latest", "fletcher32", "lzf", "vlen_string"])
def test_unsupported_features_are_named(feature, tmp_path):
    path = str(tmp_path / f"{feature}.h5")
    kw = {"libver": "latest"} if feature == "libver_latest" else {}
    with h5py.File(path, "w", **kw) as f:
        if feature == "vlen_string":
            f["x"] = "text"
        else:
            opts = {"fletcher32": dict(fletcher32=True, chunks=(4,)),
                    "lzf": dict(compression="lzf", chunks=(4,))}.get(feature, {})
            f.create_dataset("x", data=np.arange(8.0), **opts)
    match = {"libver_latest": "superblock version 3", "fletcher32": "fletcher32",
             "lzf": "lzf", "vlen_string": "variable-length"}[feature]
    with pytest.raises(NotImplementedError, match=match):
        with h5.File(path) as f:
            f["x"][()]


# ---------------------------------------------------------------- fixture


def _fixture_arrays():
    """The fixture's arrays: points on a sphere and a box, rounded to 1/256
    so that gzip keeps each file small."""
    rng = np.random.RandomState(13)
    pts = rng.randn(8, 512, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts[4:] = np.clip(pts[4:] * 1.6, -1, 1)
    normal = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    q = lambda x: (np.round(x * 256) / 256).astype(np.float32)  # noqa: E731
    return {
        "train_data": q(pts), "train_label": rng.randint(0, 40, (8, 1)).astype(np.uint8),
        "train_normal": q(normal),
        "seg_data": q(pts[::-1]), "seg_label": rng.randint(0, 16, (8, 1)).astype(np.uint8),
        "seg_pid": rng.randint(0, 50, (8, 512)).astype(np.uint8),
    }


def write_fixture():
    os.makedirs(FIXTURE, exist_ok=True)
    arrays = _fixture_arrays()
    save_h5(os.path.join(FIXTURE, "ply_data_train0.h5"), arrays["train_data"],
            arrays["train_label"], "normal", arrays["train_normal"], 4)
    save_h5(os.path.join(FIXTURE, "ply_data_seg0.h5"), arrays["seg_data"],
            arrays["seg_label"], "pid", arrays["seg_pid"], 1)
    with open(os.path.join(FIXTURE, "files.txt"), "w") as f:
        f.write("ply_data_train0.h5\nply_data_seg0.h5\n")
    np.savez_compressed(os.path.join(FIXTURE, "expected.npz"), **arrays)


def test_fixture_is_small_and_what_write_fixture_writes():
    files = sorted(os.listdir(FIXTURE))
    assert files == ["expected.npz", "files.txt", "ply_data_seg0.h5", "ply_data_train0.h5"]
    for name in files:
        if name.endswith(".h5"):
            assert os.path.getsize(os.path.join(FIXTURE, name)) < 100_000, name
    with np.load(os.path.join(FIXTURE, "expected.npz")) as z:
        want = _fixture_arrays()
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype and np.array_equal(z[k], v), k


def test_modelnet_fixture_equals_jax_without_h5py():
    files = modelnet.get_data_files(os.path.join(FIXTURE, "files.txt"))
    assert files == jax_modelnet.get_data_files(os.path.join(FIXTURE, "files.txt"))
    train, seg = files
    want = {"train": jax_modelnet.load_h5_with_normals(train),
            "seg": jax_modelnet.load_h5_with_seg(seg), "plain": jax_modelnet.load_h5(train)}
    with mock.patch.dict(sys.modules, {"h5py": None}):  # the port never needs it
        got = {"train": modelnet.load_h5_with_normals(train),
               "seg": modelnet.load_h5_with_seg(seg), "plain": modelnet.load_h5(train)}
    with np.load(os.path.join(FIXTURE, "expected.npz")) as z:
        expected = {"train": (z["train_data"], z["train_label"], z["train_normal"]),
                    "seg": (z["seg_data"], z["seg_label"], z["seg_pid"]),
                    "plain": (z["train_data"], z["train_label"])}
    for key in want:
        for a, b, c in zip(got[key], want[key], expected[key], strict=True):
            assert a.dtype == b.dtype == c.dtype
            assert np.array_equal(a, b) and np.array_equal(a, c)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Write the committed ModelNet fixture.")
    parser.add_argument("--write", action="store_true", help=f"rewrite {FIXTURE}")
    if not parser.parse_args().write:
        parser.print_help()
        sys.exit(2)
    write_fixture()
    print(f"wrote {FIXTURE}:", {n: os.path.getsize(os.path.join(FIXTURE, n))
                                 for n in sorted(os.listdir(FIXTURE))})
