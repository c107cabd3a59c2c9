"""The port's `viz/` (drawn on its NumPy canvas, no matplotlib) against the
JAX package's renders, drawn in this process with matplotlib's Agg.

Every case calls one draw function of both packages on the same seeded
inputs and holds the port to JAX at these tolerances:

  * limits: `get_xlim` / `get_ylim` (`*_3d` in 3D) of every plotting axes
    at 1e-12;
  * colors: the RGBA each marker of each scatter is mapped to, before depth
    shading (`PathCollection.get_facecolor` on JAX's side), at 1e-12;
  * positions: every marker's pixel in the uncropped figure at the
    figure's dpi, JAX's `ax.transData.transform` after `fig.canvas.draw()`
    (in 3D applied to `proj3d.proj_transform(..., ax.get_proj())`), at 0.5
    px; axes without markers are probed on a grid of data points;
    `visualize_fv` is left out, since JAX lays it out with matplotlib's
    constrained-layout solver, which the canvas does not copy;
  * PNG: the file `savefig` writes, decoded by PIL, equals the port's
    canvas byte for byte, and `viz/png.py::read_png` equals PIL on it.

Besides: every colormap table equals matplotlib's exactly, Normalize plus
the map equals `ScalarMappable.to_rgba` at 1e-12, `discrete_cmap(n)`
equals JAX's for n = 1..10, every public function of JAX's `viz/*` has a
counterpart with its name, parameters and defaults, `read_png` equals PIL
on gray 8/16-bit, RGB and RGBA files with every filter type, and
`export_shape_visualizations` writes JAX's file names.
"""

import inspect
import os
import struct
import zlib

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.cm import ScalarMappable  # noqa: E402
from matplotlib.collections import PathCollection  # noqa: E402
from matplotlib.colors import Normalize as MplNormalize  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402
from PIL import Image  # noqa: E402

from nestinet_tpu.ops import gmm as jax_gmm  # noqa: E402
from nestinet_tpu.viz import clouds as jax_clouds  # noqa: E402
from nestinet_tpu.viz import fv as jax_fv  # noqa: E402
from nestinet_tpu.viz import normals as jax_normals  # noqa: E402
from nestinet_tpu_torch.ops import gmm as port_gmm  # noqa: E402
from nestinet_tpu_torch.viz import clouds, colors, fv, normals, png  # noqa: E402
from nestinet_tpu_torch.viz.canvas import Axes3D, ColorbarAxes, Figure  # noqa: E402
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: E402,F401

COLOR_ATOL = 1e-12
LIMIT_ATOL = 1e-12
PIXEL_ATOL = 0.5

PACKAGES = {
    "jax": (jax_normals, jax_clouds, jax_fv, jax_gmm),
    "port": (normals, clouds, fv, port_gmm),
}

_rng = np.random.RandomState(5)
N = 240
PTS = _rng.randn(N, 3) * [1.0, 0.6, 0.4] + [0.2, -0.1, 0.5]
NRM = _rng.randn(N, 3)
PRED = NRM + 0.3 * _rng.randn(N, 3)
EXPERTS = _rng.randint(0, 7, N)
VALUES = _rng.uniform(-0.2, 1.2, N)
ERRORS = (_rng.rand(N) * 100).astype(np.float32)
SEG_A, SEG_B = _rng.randint(0, 4, N), _rng.randint(0, 4, N)
Y_TRUE, Y_PRED = _rng.randint(0, 5, 150), _rng.randint(0, 6, 150)
FV = _rng.randn(3, 20, 27)
PATCH = _rng.uniform(-0.9, 0.9, (80, 3))


def _phi_theta_export(nm, cl, f, g):
    """What `eval/evaluate.py::_export_shape` draws on one axes."""
    phi, theta = nm.euclidean_to_spherical(NRM)
    phi1, theta1 = nm.euclidean_to_spherical(PRED)
    ax = nm.draw_phi_theta_domain(phi, theta, color="k", title=r"$\theta(\phi)$ s")
    nm.draw_line_segments(phi, theta, phi1, theta1, ax=ax, footnote="RMS= 1.0")
    return nm.draw_phi_theta_domain(phi1, theta1, color=EXPERTS, ax=ax,
                                    cmap=nm.discrete_cmap(7), n_labels=7)


CASES = {
    "phi_theta_export": _phi_theta_export,
    "phi_theta_values": lambda nm, cl, f, g: nm.draw_phi_theta_domain(
        *nm.euclidean_to_spherical(NRM), color=VALUES, title="values"),
    "line_segments": lambda nm, cl, f, g: nm.draw_line_segments(
        *nm.euclidean_to_spherical(NRM), *nm.euclidean_to_spherical(PRED), footnote="f"),
    "pc_normals": lambda nm, cl, f, g: nm.visualize_pc_normals(PTS, NRM),
    "point_cloud": lambda nm, cl, f, g: cl.draw_point_cloud(PTS),
    "point_cloud_values": lambda nm, cl, f, g: cl.draw_point_cloud(PTS, color=VALUES),
    "pc_overlay": lambda nm, cl, f, g: cl.visualize_pc_overlay(PTS, ERRORS),
    "pc_experts": lambda nm, cl, f, g: cl.visualize_pc_experts(PTS, EXPERTS, 7),
    "pc_seg": lambda nm, cl, f, g: cl.visualize_pc_seg(PTS, SEG_A, 4),
    "pc_seg_diff": lambda nm, cl, f, g: cl.visualize_pc_seg_diff(PTS, SEG_A, SEG_B),
    "confusion": lambda nm, cl, f, g: cl.visualize_confusion_matrix(Y_TRUE, Y_PRED),
    "confusion_normalized": lambda nm, cl, f, g: cl.visualize_confusion_matrix(
        Y_TRUE, Y_PRED, classes=list("abcdef"), normalize=True, cmap="jet"),
    "fv": lambda nm, cl, f, g: f.visualize_fv(FV),
    "gaussians": lambda nm, cl, f, g: f.draw_gaussians(g.get_3d_grid_gmm((3, 3, 3))),
    "fv_with_pc": lambda nm, cl, f, g: f.visualize_fv_with_pc(FV[0], PATCH),
    "derivatives": lambda nm, cl, f, g: f.visualize_derivatives(
        PATCH, g.get_3d_grid_gmm((3, 3, 3)), 13),
    "gaussian_points": lambda nm, cl, f, g: f.draw_gaussian_points(
        PATCH, g.get_3d_grid_gmm((3, 3, 3)), 13),
}


def _figure(obj):
    obj = obj[0] if isinstance(obj, tuple) else obj
    return obj if isinstance(obj, (Figure, matplotlib.figure.Figure)) else obj.figure


@pytest.fixture(scope="module")
def renders():
    """{case: (JAX figure, port figure)}, JAX's drawn once."""
    out = {}
    for name, case in CASES.items():
        want = _figure(case(*PACKAGES["jax"]))
        want.canvas.draw()
        out[name] = (want, _figure(case(*PACKAGES["port"])))
    yield out
    plt.close("all")


def _plot_axes(want, got):
    """The plotting axes of both figures, in the same order (colorbars left
    out)."""
    a = [ax for ax in want.axes if ax.get_label() != "<colorbar>"]
    b = [ax for ax in got.axes if not isinstance(ax, ColorbarAxes)]
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.name == "3d") == isinstance(y, Axes3D)
    return list(zip(a, b))


def _scatters(ax):
    return [c for c in ax.collections if isinstance(c, PathCollection)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_limits_equal_jax(renders, case):
    for want, got in _plot_axes(*renders[case]):
        names = ("get_xlim3d", "get_ylim3d", "get_zlim3d") if want.name == "3d" else \
            ("get_xlim", "get_ylim")
        for name in names:
            np.testing.assert_allclose(getattr(got, name)(), getattr(want, name)(),
                                       atol=LIMIT_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_marker_colors_equal_jax(renders, case):
    for want, got in _plot_axes(*renders[case]):
        scatters = _scatters(want)
        assert len(scatters) == len(got.collections)
        for sc, col in zip(scatters, got.collections):
            rgba = PathCollection.get_facecolor(sc)  # before depth shading and sorting
            rgba = np.broadcast_to(rgba, col.rgba.shape)
            np.testing.assert_allclose(col.rgba, rgba, atol=COLOR_ATOL, rtol=0)


def _probe(want, got):
    """(JAX display px, port display px) of the markers of both axes or,
    where there are none, of a grid of data points inside the limits."""
    if want.name == "3d":
        if _scatters(want):
            xyz = np.concatenate([np.column_stack(sc._offsets3d) for sc in _scatters(want)])
        else:
            lims = [want.get_xlim3d(), want.get_ylim3d(), want.get_zlim3d()]
            xyz = np.array(np.meshgrid(*[np.linspace(*lim, 4) for lim in lims])).reshape(3, -1).T
        x2, y2, _ = proj3d.proj_transform(*xyz.T, want.get_proj())
        return (want.transData.transform(np.column_stack([x2, y2])),
                got.transform(np.column_stack(got.project(*xyz.T)[:2])))
    if _scatters(want):
        xy = np.concatenate([sc.get_offsets() for sc in _scatters(want)])
    else:
        xy = np.array(np.meshgrid(np.linspace(*want.get_xlim(), 5),
                                  np.linspace(*want.get_ylim(), 5))).reshape(2, -1).T
    return want.transData.transform(xy), got.transform(xy)


@pytest.mark.parametrize("case", sorted(set(CASES) - {"fv"}))
def test_marker_positions_equal_jax(renders, case):
    want_fig, got_fig = renders[case]
    h, w = np.asarray(want_fig.canvas.buffer_rgba()).shape[:2]
    assert got_fig.pixel_size() == (w, h)
    for want, got in _plot_axes(want_fig, got_fig):
        a, b = _probe(want, got)
        assert len(a) > 3
        np.testing.assert_allclose(b, a, atol=PIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_png_decodes_to_the_canvas(renders, case, tmp_path):
    fig = renders[case][1]
    path = str(tmp_path / f"{case}.png")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    with Image.open(path) as im:
        assert im.mode == "RGBA"
        decoded = np.asarray(im)
    np.testing.assert_array_equal(decoded, fig.to_rgba(150, "tight"))
    np.testing.assert_array_equal(png.read_png(path), decoded)
    assert (decoded[..., :3] != 255).any()


# --------------------------------------------------------- PNG only


FMT_CALLS = {
    "draw_phi_theta_domain": lambda fmt: normals.draw_phi_theta_domain([0.0], [0.0], fmt=fmt),
    "draw_line_segments": lambda fmt: normals.draw_line_segments([0], [0], [1], [1], fmt=fmt),
    "visualize_pc_normals": lambda fmt: normals.visualize_pc_normals(PTS, NRM, fmt=fmt),
    "draw_point_cloud": lambda fmt: clouds.draw_point_cloud(PTS, fmt=fmt),
    "visualize_pc_overlay": lambda fmt: clouds.visualize_pc_overlay(PTS, ERRORS, fmt=fmt),
    "visualize_pc_experts": lambda fmt: clouds.visualize_pc_experts(PTS, EXPERTS, fmt=fmt),
    "visualize_pc_seg": lambda fmt: clouds.visualize_pc_seg(PTS, SEG_A, 4, fmt=fmt),
    "visualize_pc_seg_diff": lambda fmt: clouds.visualize_pc_seg_diff(PTS, SEG_A, SEG_B,
                                                                      fmt=fmt),
    "visualize_confusion_matrix": lambda fmt: clouds.visualize_confusion_matrix(
        Y_TRUE, Y_PRED, fmt=fmt),
    "export_shape_visualizations": lambda fmt: clouds.export_shape_visualizations(
        PTS, NRM, PRED, "unused", "s", fmt=fmt),
    "visualize_fv": lambda fmt: fv.visualize_fv(FV, fmt=fmt),
    "draw_gaussians": lambda fmt: fv.draw_gaussians(port_gmm.get_3d_grid_gmm((2, 2, 2)),
                                                    fmt=fmt),
    "visualize_fv_with_pc": lambda fmt: fv.visualize_fv_with_pc(FV[0], PATCH, fmt=fmt),
    "visualize_derivatives": lambda fmt: fv.visualize_derivatives(
        PATCH, port_gmm.get_3d_grid_gmm((2, 2, 2)), 1, fmt=fmt),
    "draw_gaussian_points": lambda fmt: fv.draw_gaussian_points(
        PATCH, port_gmm.get_3d_grid_gmm((2, 2, 2)), 1, fmt=fmt),
}


@pytest.mark.parametrize("name", sorted(FMT_CALLS))
def test_other_formats_raise(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="PNG only"):
        FMT_CALLS[name]("pdf")
    assert not os.listdir(tmp_path)


# --------------------------------------------------------- colors


CMAPS = ["jet", "nipy_spectral", "RdYlGn_r", "viridis", "seismic", "jet_r", "viridis_r"]


@pytest.mark.parametrize("name", CMAPS)
def test_colormap_table_equals_matplotlib(name):
    want = plt.get_cmap(name)(np.arange(256))
    np.testing.assert_array_equal(colors.get_cmap(name)(np.arange(256)), want)


@pytest.mark.parametrize("vrange", [(None, None), (0.0, 90.0), (-0.5, 6.5)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "uint8"])
def test_normalize_and_map_equal_scalar_mappable(dtype, vrange):
    rng = np.random.RandomState(9)
    x = (rng.randn(500) * 30 + 40).clip(0, 250).astype(dtype)
    if dtype.startswith("float"):
        x[:2] = [np.nan, 1e9]
    for name in ("jet", "viridis"):
        # masked where not finite, as scatter's `set_array` hands it on
        want = ScalarMappable(norm=MplNormalize(*vrange), cmap=name).to_rgba(
            np.ma.masked_invalid(x))
        got = colors.get_cmap(name)(colors.Normalize(*vrange)(x))
        np.testing.assert_allclose(got, want, atol=COLOR_ATOL, rtol=0)


@pytest.mark.parametrize("n", range(1, 11))
def test_discrete_cmap_equals_jax(n):
    want = jax_normals.discrete_cmap(n)
    got = normals.discrete_cmap(n)
    assert got.N == want.N == n
    np.testing.assert_array_equal(got.colors, np.asarray(want.colors))
    x = np.linspace(-0.2, 1.2, 57)
    np.testing.assert_array_equal(got(x), want(x))


def test_named_colors_equal_matplotlib():
    for c in ("k", "r", "b", "0.7", "steelblue", "black", "white", "#1f77b4", (0.1, 0.2, 0.3)):
        assert colors.to_rgba(c) == matplotlib.colors.to_rgba(c), c


# --------------------------------------------------------- names and signatures


def _public_functions(module):
    return {n: f for n, f in vars(module).items()
            if inspect.isfunction(f) and not n.startswith("_")}


@pytest.mark.parametrize("jax_module,port_module", [
    (jax_normals, normals), (jax_clouds, clouds), (jax_fv, fv)],
    ids=["normals", "clouds", "fv"])
def test_every_jax_function_has_its_counterpart(jax_module, port_module):
    want = _public_functions(jax_module)
    assert len(want) >= 5
    for name, fn in want.items():
        got = getattr(port_module, name, None)
        assert callable(got), name
        a = inspect.signature(fn).parameters
        b = inspect.signature(got).parameters
        assert [(p.name, p.kind, p.default) for p in a.values()] == \
               [(p.name, p.kind, p.default) for p in b.values()], name


# --------------------------------------------------------- PNG reader


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(path, img, color, depth):
    """A PNG of `img` (gray, RGB or RGBA at 8 or 16 bits) whose row y has
    filter y % 5, so that every filter type occurs."""
    h, w = img.shape[:2]
    raw = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = raw.reshape(h, -1).astype(np.int64)
    bpp = raw.shape[1] // w
    out, prior = [], np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        row, kind = raw[y], y % 5
        left = np.r_[np.zeros(bpp, np.int64), row[:-bpp]]
        upleft = np.r_[np.zeros(bpp, np.int64), prior[:-bpp]]
        pred = [0, left, prior, (left + prior) // 2, _paeth(left, prior, upleft)][kind]
        out.append(bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prior = row
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgba8", "rgb16", "rgba16"])
def test_read_png_equals_pil(kind, tmp_path):
    rng = np.random.RandomState(4)
    depth = 16 if kind.endswith("16") else 8
    channels = {"gray": 1, "rgb": 3, "rgba": 4}[kind.rstrip("0123456789")]
    shape = (11, 13) if channels == 1 else (11, 13, channels)
    img = rng.randint(0, 2 ** depth, shape).astype(np.uint16 if depth == 16 else np.uint8)
    img[3:7] = img[2]  # runs that the filters predict exactly
    path = str(tmp_path / "f.png")
    _encode(path, img, {1: 0, 3: 2, 4: 6}[channels], depth)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, img)
    if depth == 8 or channels == 1:  # PIL reads 16-bit color as 8-bit
        with Image.open(path) as im:
            np.testing.assert_array_equal(got, np.asarray(im).astype(got.dtype))
    assert png.read_header(path)[:2] == (13, 11)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)).convert("P").save(path)
    with pytest.raises(ValueError, match="palette"):
        png.read_png(path)
    png.write_png(path, np.zeros((2, 3, 4), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 0xFF  # inside IDAT
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        png.read_png(path)


# --------------------------------------------------------- the export set


def test_export_shape_visualizations_writes_jax_files(tmp_path):
    kw = dict(experts=EXPERTS, n_experts=7, angle_errors=ERRORS)
    want = jax_clouds.export_shape_visualizations(PTS, NRM, PRED, str(tmp_path / "jax"),
                                                  "shape", **kw)
    got = clouds.export_shape_visualizations(PTS, NRM, PRED, str(tmp_path / "port"),
                                             "shape", **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
           [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert len(got) == 4
    for path in got:
        with Image.open(path) as im:
            np.testing.assert_array_equal(png.read_png(path), np.asarray(im))


# --------------------------------------------------------- bar charts


@pytest.mark.parametrize("values", [
    [3.5, 0.0, 12.25, 7.0, 0.5, 9.0, 1.0], [0, 0, 0, 0, 0, 0, 0], [120, 0, 33, 4, 0, 71, 9]],
    ids=["errors", "zeros", "counts"])
def test_bar_chart_equals_matplotlib(values):
    """The axes `eval/expert_stats.py::_bar` draws, as JAX's `_bar`
    draws it: limits (a bar's sticky zero) and pixels."""
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(np.arange(7), values)
    ax.set_xticks(range(7))
    ax.set_title("Expert point count — shape")
    fig.canvas.draw()
    from nestinet_tpu_torch.viz.canvas import subplots
    _, got = subplots(figsize=(6, 4))
    got.bar(np.arange(7), values)
    got.set_xticks(range(7))
    np.testing.assert_allclose(got.get_xlim(), ax.get_xlim(), atol=LIMIT_ATOL, rtol=0)
    np.testing.assert_allclose(got.get_ylim(), ax.get_ylim(), atol=LIMIT_ATOL, rtol=0)
    corners = np.column_stack([np.arange(7) - 0.4, values])
    np.testing.assert_allclose(got.transform(corners), ax.transData.transform(corners),
                               atol=PIXEL_ATOL, rtol=0)
    plt.close(fig)
