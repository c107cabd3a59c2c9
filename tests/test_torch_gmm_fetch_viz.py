"""The last library modules of the port against the JAX package's.

* `ops/gmm.py::get_learned_gmm` / `fit_diag_gmm`: the NumPy EM against
  sklearn's `GaussianMixture(covariance_type="diag")` (what JAX fits with,
  `nestinet_tpu/ops/gmm.py:161-185`) on well-separated clusters, weights,
  means and variances within `EM_ATOL` after sorting the components; the
  cache files read by either package and written byte-identical; the same
  errors as JAX's `get_gmm(type="learn")`.
* `cli/fetch.py`: JAX's three offline cases (`tests/test_fetch.py:71-99`:
  a loopback HTTP server serving a zip built in the test, an unknown
  target, an unreachable URL), parametrised over both packages' `fetch`.
  Nothing is downloaded.
* `viz/`: the NumPy helpers equal to JAX's on seeded inputs (exactly).
"""

import os

import numpy as np
import pytest

from nestinet_tpu.cli import fetch as jax_fetch
from nestinet_tpu.ops import gmm as jax_gmm
from nestinet_tpu_torch.cli import fetch as torch_fetch
from nestinet_tpu_torch.ops import gmm
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401
from tests.test_fetch import loopback_server  # noqa: F401

EM_ATOL = 1e-3  # weights, means and variances against sklearn's fit


def clusters(seed: int, k: int, dim: int, n: int = 3000):
    """[n, dim] points of k diagonal Gaussians 12 apart on the first axis,
    unequal weights and per-axis spreads 0.3-1.2."""
    rng = np.random.RandomState(seed)
    weights = rng.dirichlet(np.full(k, 4.0))
    counts = np.maximum(rng.multinomial(n, weights), 20)
    means = rng.uniform(-3, 3, (k, dim))
    means[:, 0] = 12.0 * np.arange(k)
    spreads = rng.uniform(0.3, 1.2, (k, dim))
    pts = np.concatenate([m + s * rng.randn(c, dim) for m, s, c in zip(means, spreads, counts)])
    return pts[rng.permutation(len(pts))]


def sorted_components(weights, means, covariances):
    order = np.argsort(means[:, 0])
    return weights[order], means[order], covariances[order]


@pytest.mark.parametrize("seed,k,dim", [(0, 3, 3), (1, 5, 3), (2, 4, 2)])
def test_em_matches_sklearn(seed, k, dim):
    from sklearn.mixture import GaussianMixture

    pts = clusters(seed, k, dim)
    want = GaussianMixture(n_components=k, covariance_type="diag", random_state=seed).fit(pts)
    got = gmm.get_learned_gmm(pts, k, seed=seed)
    assert isinstance(got, gmm.GridGMM)
    for g, w, name in zip(sorted_components(got.weights, got.means, got.covariances),
                          sorted_components(want.weights_, want.means_, want.covariances_),
                          ("weights", "means", "variances")):
        np.testing.assert_allclose(g, w, atol=EM_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got.weights.sum(), 1.0, rtol=1e-12)


def test_em_is_seeded():
    pts = clusters(3, 4, 3)[:400] + np.random.RandomState(4).randn(400, 3) * 6
    a, b = (gmm.get_learned_gmm(pts, 6, seed=7) for _ in range(2))
    np.testing.assert_array_equal(a.means, b.means)
    np.testing.assert_array_equal(a.covariances, b.covariances)


def test_lloyd_step_relocation_leaves_no_nan():
    """An empty cluster (center 100) takes the point farthest from its
    center (5, of the center 9), which leaves that center's cluster empty
    in turn: it moves to the largest cluster's center, as sklearn's
    `_average_centers` puts it, and no center is NaN."""
    x = np.array([[0.0], [0.1], [5.0]])
    labels, centers = gmm._lloyd_step(x, (x * x).sum(axis=1), np.array([[0.0], [100.0], [9.0]]))
    np.testing.assert_array_equal(labels, [0, 0, 1])
    np.testing.assert_allclose(centers[:, 0], [0.05, 5.0, 0.05], rtol=1e-12)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_cache_round_trips_with_jax(tmp_path):
    """Each package reads the other's `gmm_g{n}_N{N}.json` and writes the
    same GMM byte for byte."""
    pts = clusters(5, 3, 3)
    name = f"gmm_g3_N{len(pts)}.json"
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")

    fitted = gmm.get_learned_gmm(pts, 3, cache_dir=port_dir, seed=0)
    read = jax_gmm.get_learned_gmm(pts, 3, cache_dir=port_dir)  # a cache hit, no fit
    for attr in ("weights", "means", "covariances"):
        np.testing.assert_array_equal(getattr(read, attr), getattr(fitted, attr))
    jax_gmm.GridGMM(fitted.weights, fitted.means, fitted.covariances).save(str(tmp_path / "j"))
    assert _bytes(os.path.join(port_dir, name)) == _bytes(str(tmp_path / "j"))

    jax_fitted = jax_gmm.get_learned_gmm(pts, 3, cache_dir=jax_dir)
    read = gmm.get_learned_gmm(pts, 3, cache_dir=jax_dir, seed=1)  # a cache hit, no fit
    for attr in ("weights", "means", "covariances"):
        np.testing.assert_array_equal(getattr(read, attr), getattr(jax_fitted, attr))
    read.save(str(tmp_path / "p"))
    assert _bytes(os.path.join(jax_dir, name)) == _bytes(str(tmp_path / "p"))


@pytest.mark.parametrize("args,kwargs", [
    ((np.zeros((10, 3)), [2, 2]), {"type": "learn"}),
    ((None, 2), {"type": "learn"}),
    ((np.zeros((10, 3)), 2), {"type": "sklearn"}),
    ((np.random.RandomState(0).randn(2, 3), 3), {"type": "learn"}),
])
def test_learned_gmm_raises_as_jax(args, kwargs):
    with pytest.raises(ValueError) as want:
        jax_gmm.get_gmm(*args, **kwargs)
    with pytest.raises(ValueError) as got:
        gmm.get_gmm(*args, **kwargs)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ cli.fetch

PACKAGES = {"jax": jax_fetch, "port": torch_fetch}


def test_fetch_copies_jax_resources():
    assert torch_fetch.RESOURCES == jax_fetch.RESOURCES
    assert torch_fetch.BASE_URL == jax_fetch.BASE_URL


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_fetch_download_unzip_layout(package, tmp_path, loopback_server,  # noqa: F811
                                     monkeypatch):
    from nestinet_tpu_torch.data.pcpnet import load_shape

    fetch = PACKAGES[package]
    monkeypatch.setattr(fetch, "BASE_URL", loopback_server)
    root = str(tmp_path / "repo")
    fetch.main(["pcpnet_data", "--root", root])
    data_dir = os.path.join(root, "data", "pcpnet")
    assert os.path.exists(os.path.join(data_dir, "testset.txt"))
    assert not os.path.exists(os.path.join(root, "data", "pcpnet.zip"))
    shape = load_shape(data_dir, "mini", with_normals=True)
    assert shape.pts.shape == (50, 3)
    assert shape.normals.shape == (50, 3)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_fetch_unknown_target_rejected(package, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        PACKAGES[package].main(["no_such_resource", "--root", str(tmp_path)])
    assert "unknown target no_such_resource" in str(e.value.code)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_fetch_unreachable_fails_gracefully(package, tmp_path, monkeypatch, capsys):
    fetch = PACKAGES[package]
    monkeypatch.setattr(fetch, "BASE_URL", "http://127.0.0.1:9")
    with pytest.raises(SystemExit) as e:
        fetch.main(["pcpnet_data", "--root", str(tmp_path)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAILED" in out and f"unzip into {os.path.join(str(tmp_path), 'data/')}" in out


# ------------------------------------------------------------------- viz

def test_viz_helpers_equal_jax():
    from nestinet_tpu.viz import clouds as jax_clouds
    from nestinet_tpu.viz import fv as jax_fv
    from nestinet_tpu.viz import normals as jax_normals
    from nestinet_tpu_torch import viz

    rng = np.random.RandomState(11)
    normals = rng.randn(200, 3)
    normals[::17] = 0.0
    for degrees in (True, False):
        for got, want in zip(viz.euclidean_to_spherical(normals, degrees),
                             jax_normals.euclidean_to_spherical(normals, degrees)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(viz.normal2rgb(normals), jax_normals.normal2rgb(normals))
    cloud = rng.uniform(-3, 5, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(viz.normalize_to_unit_sphere(cloud),
                                  jax_clouds.normalize_to_unit_sphere(cloud))
    np.testing.assert_array_equal(viz.normalize_to_unit_sphere(np.ones((4, 3))),
                                  jax_clouds.normalize_to_unit_sphere(np.ones((4, 3))))
    for subdiv in (5, 12):
        for got, want in zip(viz.unit_sphere(subdiv), jax_fv._unit_sphere(subdiv)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalize", [False, True])
def test_confusion_counts_equal_jax_heatmap(normalize):
    """The counts `visualize_confusion_matrix` returns beside its axes, and
    draws (its image's array)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nestinet_tpu.viz.clouds import visualize_confusion_matrix
    from nestinet_tpu_torch.viz import confusion_counts

    rng = np.random.RandomState(3)
    y_true, y_pred = rng.randint(0, 5, 400), rng.randint(0, 7, 400)
    y_true[y_true == 2] = 4  # an empty row
    ax, want = visualize_confusion_matrix(y_true, y_pred, normalize=normalize)
    drawn = np.asarray(ax.images[0].get_array())
    plt.close(ax.figure)
    got = confusion_counts(y_true, y_pred, normalize)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, drawn)
    np.testing.assert_array_equal(confusion_counts([], []), np.zeros((1, 1)))
