"""The port's own host modules against the JAX package's originals.

The port keeps copies of the host layers it serves with (`core.config`,
`core.rundir`, `core.textio`, `data.*`, `eval.*` and the two C++ sources),
so that it imports nothing of `nestinet_tpu`.  Each test here feeds both
the same inputs and requires the same result: fields and defaults, batches
from the same seed, bytes on disk, scores.
"""

import dataclasses
import os

import numpy as np
import pytest

from nestinet_tpu.core import textio as jax_textio
from nestinet_tpu.core.config import Config as JaxConfig
from nestinet_tpu.core.rundir import RunDir as JaxRunDir
from nestinet_tpu.data import native as jax_native
from nestinet_tpu.data import synthetic as jax_synthetic
from nestinet_tpu.data.loader import get_data_loader as jax_loader
from nestinet_tpu.eval.evaluate import evaluate_dataset as jax_evaluate
from nestinet_tpu_torch.core import textio
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.core.rundir import RunDir
from nestinet_tpu_torch.data import native, synthetic
from nestinet_tpu_torch.data.loader import get_data_loader
from nestinet_tpu_torch.eval.evaluate import evaluate_dataset

from .fixtures import make_plane, make_sphere, write_pcpnet_dataset
from .test_torch_native_race import load_jax_native
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".npy"):
                continue  # the loaders' caches
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host_data"))
    rng = np.random.RandomState(5)
    shapes = {"plane": make_plane(180, rng, noise=0.01),
              "sphere": make_sphere(150, rng, noise=0.01)}
    name = write_pcpnet_dataset(root, shapes, list_name="testset.txt", n_pidx=40, seed=5)
    return root, name


def test_config_has_the_same_fields_and_defaults():
    ours = {f.name: f for f in dataclasses.fields(Config)}
    theirs = {f.name: f for f in dataclasses.fields(JaxConfig)}
    assert list(ours) == list(theirs)
    for name, f in theirs.items():
        assert ours[name].type == f.type, name
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())


def test_config_json_round_trips_between_the_packages(tmp_path):
    cfg = Config(model="experts_n_est", patch_radius=(0.01, 0.03), num_point=64,
                 compute_dtype="int8", fold_bn=True)
    cfg.save(str(tmp_path / "a.json"))
    back = JaxConfig.load(str(tmp_path / "a.json"))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    back.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert dataclasses.asdict(Config.load(str(tmp_path / "b.json"))) == dataclasses.asdict(cfg)


def test_rundir_numbers_and_paths_as_the_original(tmp_path):
    for cls, sub in ((JaxRunDir, "jax"), (RunDir, "port")):
        base = str(tmp_path / sub)
        runs = [cls.create(base) for _ in range(3)]
        assert [os.path.relpath(r.path, base) for r in runs] == [".", "1", "2"]
        rd = cls.open(runs[1].path)
        assert os.path.relpath(rd.config_path, base) == os.path.join("1", "config.json")
        assert os.path.relpath(rd.gmm_path, base) == os.path.join("1", "gmm.json")
        assert os.path.isdir(rd.ckpt_dir)
        assert os.path.isdir(rd.results_dir("pcpnet"))
        rd.write_description("run")
        rd.log("one line")
        rd.close()
    assert _files(str(tmp_path / "jax")) == _files(str(tmp_path / "port"))
    with pytest.raises(FileNotFoundError):
        RunDir.open(str(tmp_path / "missing"))


@pytest.mark.parametrize("case", ["full", "pidx", "pca_mean"])
@pytest.mark.parametrize("use_native", [True, False])
def test_loader_yields_the_same_batches(dataset, case, use_native):
    root, name = dataset
    load_jax_native()
    kwargs = dict(indir=root, batch_size=32, patch_radius=(0.05, 0.1), points_per_patch=24,
                  seed=11, sparse_patches=case == "pidx", workers=2, use_native=use_native)
    if case == "pca_mean":
        # radii wide enough that every ball holds three points for the SVD
        kwargs.update(use_pca=True, patch_center="mean", patch_radius=(0.2, 0.3))
    ours, ds = get_data_loader(name, **kwargs)
    theirs, jds = jax_loader(name, outputs=(), patch_sample_order="full", **kwargs)
    assert ds.use_native == jds.use_native
    a, b = list(ours), list(theirs)
    assert len(a) == len(b) > 1
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(np.asarray(x[key]), np.asarray(y[key]), err_msg=key)
    assert sum(len(x["points"]) for x in a) == (80 if case == "pidx" else 330)


def test_native_sampler_builds_into_the_port(dataset):
    """The port's library builds into its own build directory and, once
    JAX's is loaded too, samples exactly what JAX's samples."""
    assert native.available()
    lib = native._LIB
    assert os.path.dirname(lib).endswith(os.path.join("nestinet_tpu_torch", "_build"))
    assert os.path.isfile(lib)
    assert load_jax_native()
    pts = np.random.RandomState(0).rand(300, 3).astype(np.float32)
    got = native.NativePatchSampler(pts).sample_patches(np.arange(20), (0.2, 0.4), 16, seed=9)
    want = jax_native.NativePatchSampler(pts).sample_patches(np.arange(20), (0.2, 0.4), 16,
                                                             seed=9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sparse_patches", [True, False])
def test_evaluate_gives_the_same_scores(dataset, tmp_path, sparse_patches):
    root, name = dataset
    rng = np.random.RandomState(8)
    res = tmp_path / "results"
    res.mkdir()
    for shape in ("plane", "sphere"):
        gt = np.loadtxt(os.path.join(root, shape + ".normals"))
        pred = gt + 0.1 * rng.randn(*gt.shape)
        pred[::4] *= -1
        np.savetxt(str(res / (shape + ".normals")), pred)
    dset = name[:-4]
    ours = evaluate_dataset(root, str(res), dset, sparse_patches=sparse_patches,
                            log=lambda *_: None)
    summary = res / "summary" / f"{dset}_evaluation_results.txt"
    ours_txt = summary.read_bytes()
    theirs = jax_evaluate(root, str(res), dset, sparse_patches=sparse_patches,
                          log=lambda *_: None)
    assert ours == theirs
    assert summary.read_bytes() == ours_txt
    assert 0 < ours["rms"] < 90


@pytest.mark.parametrize("case", ["f64_table", "f64_column", "i64_column", "f32_fallback",
                                  "nan_inf"])
def test_textio_writes_the_same_bytes(tmp_path, case):
    rng = np.random.RandomState(2)
    arr, fmt = {
        "f64_table": (rng.randn(50, 3) * 10.0 ** rng.randint(-8, 8, (50, 3)), "%.18e"),
        "f64_column": (rng.randn(40), "%.18e"),
        "i64_column": (rng.randint(-5, 1000, 60).astype(np.int64), "%i"),
        "f32_fallback": (rng.randn(10, 3).astype(np.float32), "%.18e"),
        "nan_inf": (np.array([[1.0, np.inf, -np.inf], [0.0, -0.0, 1e-300]]), "%.18e"),
    }[case]
    paths = {k: str(tmp_path / f"{k}.txt") for k in ("port", "jax", "numpy")}
    textio.savetxt(paths["port"], arr, fmt=fmt)
    jax_textio.savetxt(paths["jax"], arr, fmt=fmt)
    np.savetxt(paths["numpy"], arr, fmt=fmt)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["port"] == data["jax"] == data["numpy"]


def test_textio_builds_into_the_port():
    if textio.get_library() is None:
        assert jax_textio.get_library() is None
        return
    assert os.path.dirname(textio._LIB).endswith(os.path.join("nestinet_tpu_torch", "_build"))
    assert textio._SRC.endswith(os.path.join("nestinet_tpu_torch", "csrc", "textio.cpp"))


@pytest.mark.parametrize("seed", [3, 11])
def test_synthetic_writes_the_same_files(tmp_path, seed):
    ours = synthetic.build_protocol_benchmark(str(tmp_path / "port"), n_points=120,
                                              n_pidx=20, seed=seed)
    theirs = jax_synthetic.build_protocol_benchmark(str(tmp_path / "jax"), n_points=120,
                                                    n_pidx=20, seed=seed)
    assert ours == theirs
    a, b = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert len(a) > 20 and a.keys() == b.keys()
    for name in a:
        assert a[name] == b[name], name


def test_the_port_carries_its_own_cpp_sources():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native._SRC == os.path.join(repo, "nestinet_tpu_torch", "csrc", "patch_sampler.cpp")
    for src in ("patch_sampler.cpp", "textio.cpp"):
        assert os.path.isfile(os.path.join(repo, "nestinet_tpu_torch", "csrc", src))
