"""A small raster figure in NumPy: the part of matplotlib the port's
renders call, drawn without matplotlib.

`Figure(figsize, dpi)` holds axes; `Figure.draw(dpi)` rasterizes them into
an [H, W, 4] uint8 RGBA buffer (`Figure.buffer`), and `savefig` writes it
as a PNG (`viz/png.py`).  What is drawn where follows matplotlib 3.10's
rules, so that the port's figures put every marker where the JAX package's
put it:

  * layout: subplots on matplotlib's default grid (left 0.125, right 0.9,
    bottom 0.11, top 0.88, wspace = hspace = 0.2); a colorbar takes its
    share of the parent's cell as `make_axes_gridspec` does and anchors the
    parent to the right; an axes with `aspect="equal"` (imshow) and every 3D
    axes shrink to their aspect inside their box, centred;
  * limits: data limits plus 5% margins, stopped at sticky edges (a bar's
    zero, an image's extent at +-0.5 around the pixel centres); in 3D the 5%
    margin, then 1/48 of the range on either side;
  * 3D: matplotlib's default view (elev 30, azim -60, roll 0), perspective
    with focal length 1 and camera distance 10, box aspect 4:4:3 unless set,
    the projected coordinates mapped through the 2D view (-0.095, 0.09) on
    both axes; markers drawn far to near and faded with depth (alpha times
    1 - 0.7 * normalized depth, matplotlib's `art3d._zalpha`);
  * sizes: a scatter marker of size s covers a disc of diameter sqrt(s)
    points plus its 1.5 pt edge, a line's width is in points, text sizes are
    in points (1 pt = dpi / 72 px);
  * `bbox_inches="tight"` crops to the pixels that differ from the white
    background plus a pad of 0.1 inch.

Text is drawn with a fixed 5 x 8 bitmap font of printable ASCII, scaled
by whole pixels.  Mathtext is drawn as its plain words (`$\\phi$` as
`phi`, `$\\theta$` as `theta`: the `$` and backslashes are dropped) and
any other character outside printable ASCII (the `—` of the expert
titles) as `-`.  Only PNG is written: another `fmt` raises ValueError,
since the port has no vector backend.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np

from .colors import Colormap, Normalize, get_cmap, to_rgba, to_rgba_array
from .png import write_png

SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2, hspace=0.2)
DEFAULT_CYCLE = "#1f77b4"  # matplotlib's C0
PANE_RGBA = (0.95, 0.95, 0.95, 0.5)
_VIEW2D = (-0.95 / 10, 0.9 / 10)  # Axes3D.set_top_view at camera distance 10

# ---------------------------------------------------------------- bitmap font

# The classic 5 x 8 LCD font: five column bytes a glyph, bit 0 the top row,
# for the printable ASCII characters 0x20 (' ') to 0x7E ('~').
_FONT_HEX = (
    "0000000000 00005f0000 0007000700 147f147f14 242a7f2a12 2313086462 3649562050 "
    "0008070300 001c224100 0041221c00 2a1c7f1c2a 08083e0808 0080703000 0808080808 "
    "0000606000 2010080402 3e5149453e 00427f4000 7249494946 2141494d33 1814127f10 "
    "2745454539 3c4a494931 4121110907 3649494936 464949291e 0000140000 0040340000 "
    "0008142241 1414141414 0041221408 0201590906 3e415d594e 7c1211127c 7f49494936 "
    "3e41414122 7f4141413e 7f49494941 7f09090901 3e41415173 7f0808087f 00417f4100 "
    "2040413f01 7f08142241 7f40404040 7f021c027f 7f0408107f 3e4141413e 7f09090906 "
    "3e4151215e 7f09192946 2649494932 03017f0103 3f4040403f 1f2040201f 3f4038403f "
    "6314081463 0304780403 6159494d43 007f414141 0204081020 004141417f 0402010204 "
    "4040404040 0003070800 2054547840 7f28444438 3844444428 384444287f 3854545418 "
    "00087e0902 18a4a49c78 7f08040478 00447d4000 2040403d00 7f10284400 00417f4000 "
    "7c04780478 7c08040478 3844444438 fc18242418 18242418fc 7c08040408 4854545424 "
    "04043f4424 3c4040207c 1c2040201c 3c4030403c 4428102844 4c9090907c 4464544c44 "
    "0008364100 0000770000 0041360800 0201020402"
)


def _font() -> np.ndarray:
    """[95, 8, 5] bool glyphs of printable ASCII."""
    cols = bytes.fromhex(_FONT_HEX.replace(" ", ""))
    assert len(cols) == 95 * 5
    col = np.frombuffer(cols, np.uint8).reshape(95, 5)
    return ((col[:, None, :] >> np.arange(8)[None, :, None]) & 1).astype(bool)


_GLYPHS = _font()


def plain_text(s: str) -> str:
    """What the bitmap font draws for `s`: mathtext as plain words, other
    characters outside printable ASCII as '-'."""
    s = re.sub(r"\\([A-Za-z]+)", r"\1", s).replace("\\", "").replace("$", "")
    return "".join(ch if " " <= ch <= "~" else "-" for ch in s)


def text_mask(s: str, size_px: float) -> np.ndarray:
    """[h, w] bool pixels of `s` in the bitmap font, scaled by whole pixels
    so that a capital is about 0.7 of `size_px` tall."""
    s = plain_text(s)
    k = max(1, int(round(size_px / 10.0)))
    if not s:
        return np.zeros((8 * k, 0), bool)
    idx = np.frombuffer(s.encode("ascii"), np.uint8).astype(int) - 32
    cells = np.zeros((len(s), 8, 6), bool)
    cells[:, :, :5] = _GLYPHS[idx]
    row = cells.transpose(1, 0, 2).reshape(8, 6 * len(s))[:, :-1]
    return np.repeat(np.repeat(row, k, 0), k, 1)


# ---------------------------------------------------------------- raster


class Raster:
    """An opaque white RGB canvas of float64 in [0, 1], drawn by
    compositing fragments (pixel, RGBA) in order, each over the pixel as
    it stands."""

    def __init__(self, width: int, height: int, dpi: float):
        self.w, self.h, self.dpi = width, height, dpi
        self.rgb = np.ones((height * width, 3))

    def px(self, pt):
        return np.asarray(pt, float) * self.dpi / 72.0

    def composite(self, idx: np.ndarray, rgba: np.ndarray) -> None:
        """Fragments `idx` (flat pixel index) with colors `rgba` (alpha
        already scaled by coverage), composited in the order given:
        out = bg * prod(1 - a_i) + sum_i c_i a_i prod_{j > i}(1 - a_j)."""
        if idx.size == 0:
            return
        order = np.argsort(idx, kind="stable")
        idx, rgba = idx[order], rgba[order]
        a = np.clip(rgba[:, 3], 0.0, 1.0 - 1e-12)
        t = np.log1p(-a)
        suffix = np.cumsum(t[::-1])[::-1]  # sum_{j >= i} t_j over the whole array
        starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
        ends = np.r_[starts[1:], idx.size]  # one past each pixel's last fragment
        after_end = np.r_[suffix, 0.0][ends]
        group_of = np.repeat(np.arange(starts.size), ends - starts)
        later = np.exp(suffix - t - after_end[group_of])  # prod_{j > i} (1 - a_j)
        contrib = rgba[:, :3] * (a * later)[:, None]
        pix = idx[starts]
        keep = np.exp(suffix[starts] - after_end)  # prod over the pixel's fragments
        summed = np.zeros((starts.size, 3))
        np.add.at(summed, group_of, contrib)
        self.rgb[pix] = self.rgb[pix] * keep[:, None] + summed

    def coverage(self, idx: np.ndarray, cov: np.ndarray, rgba) -> None:
        """One artist of one color: the union (max) of its coverage per
        pixel, composited once."""
        ok = (cov > 0)
        if not ok.any():
            return
        pix, inv = np.unique(idx[ok], return_inverse=True)
        most = np.zeros(pix.size)
        np.maximum.at(most, inv, cov[ok])
        col = np.broadcast_to(np.asarray(rgba, float), (pix.size, 4)).copy()
        col[:, 3] *= most
        self.composite(pix, col)

    def to_index(self, x: np.ndarray, y: np.ndarray):
        """Flat pixel index of display points (x right, y up from the
        bottom) and whether each lies on the canvas."""
        col = np.floor(x).astype(np.int64)
        row = np.floor(self.h - y).astype(np.int64)
        ok = (col >= 0) & (col < self.w) & (row >= 0) & (row < self.h)
        return row * self.w + col, ok

    def discs(self, x, y, radius, rgba) -> None:
        """Antialiased discs at display points, in order; `radius` (px) is
        a scalar or one a disc, `rgba` [N, 4]."""
        n = len(x)
        if n == 0:
            return
        radius = np.broadcast_to(np.asarray(radius, float), (n,))
        rgba = np.asarray(rgba, float)
        for r in np.unique(radius):  # one stencil per size
            sel = np.flatnonzero(radius == r)
            k = int(math.ceil(r + 1))
            dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
            cx = np.floor(x[sel])[:, None] + dx.ravel()[None, :] + 0.5
            cy = np.floor(y[sel])[:, None] + dy.ravel()[None, :] + 0.5
            dist = np.hypot(cx - x[sel][:, None], cy - y[sel][:, None])
            cov = np.clip(r + 0.5 - dist, 0.0, 1.0)
            idx, ok = self.to_index(cx, cy)
            ok &= cov > 0
            frag = np.repeat(rgba[sel][:, None, :], cov.shape[1], axis=1)
            frag[..., 3] *= cov
            self.composite(idx[ok], frag[ok])

    def segments(self, x0, y0, x1, y1, width_px: float, rgba) -> None:
        """Line segments of one color and width, all in one pass: points
        every half pixel along each, each point a disc of the line's width
        (at least one pixel, fainter when thinner)."""
        x0, y0, x1, y1 = (np.asarray(v, float).ravel() for v in (x0, y0, x1, y1))
        if x0.size == 0:
            return
        length = np.hypot(x1 - x0, y1 - y0)
        steps = np.ceil(length / 0.5).astype(np.int64) + 1
        seg = np.repeat(np.arange(x0.size), steps)
        first = np.repeat(np.cumsum(steps) - steps, steps)
        t = (np.arange(seg.size) - first) / np.maximum(steps[seg] - 1, 1)
        px = x0[seg] + (x1 - x0)[seg] * t
        py = y0[seg] + (y1 - y0)[seg] * t
        r = max(width_px, 1.0) / 2.0
        k = int(math.ceil(r))
        dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
        cx = np.floor(px)[:, None] + dx.ravel()[None, :] + 0.5
        cy = np.floor(py)[:, None] + dy.ravel()[None, :] + 0.5
        dist = np.hypot(cx - px[:, None], cy - py[:, None])
        cov = np.clip(r + 0.5 - dist, 0.0, 1.0) * min(width_px, 1.0)
        idx, ok = self.to_index(cx, cy)
        self.coverage(idx[ok], cov[ok], rgba)

    def polygon(self, xs, ys, rgba) -> None:
        """A filled convex polygon (display vertices in order)."""
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        c0, c1 = int(max(np.floor(xs.min()), 0)), int(min(np.ceil(xs.max()), self.w))
        r0 = int(max(np.floor(self.h - ys.max()), 0))
        r1 = int(min(np.ceil(self.h - ys.min()), self.h))
        if c0 >= c1 or r0 >= r1:
            return
        rr, cc = np.mgrid[r0:r1, c0:c1]
        px, py = cc.ravel() + 0.5, self.h - (rr.ravel() + 0.5)
        cross = [(xs[(i + 1) % len(xs)] - xs[i]) * (py - ys[i])
                 - (ys[(i + 1) % len(xs)] - ys[i]) * (px - xs[i]) for i in range(len(xs))]
        cross = np.stack(cross)
        inside = (cross >= 0).all(0) | (cross <= 0).all(0)
        self.coverage((rr.ravel() * self.w + cc.ravel())[inside],
                      np.ones(int(inside.sum())), rgba)

    def rect(self, x0, y0, x1, y1, rgba) -> None:
        self.polygon([x0, x1, x1, x0], [y0, y0, y1, y1], rgba)

    def image(self, box, colors: np.ndarray, flip_y: bool) -> None:
        """An [rows, cols, 4] color grid stretched over the display box
        (x0, y0, x1, y1), nearest neighbour; row 0 at the top unless
        `flip_y`."""
        x0, y0, x1, y1 = box
        c0, c1 = int(max(np.floor(min(x0, x1)), 0)), int(min(np.ceil(max(x0, x1)), self.w))
        r0 = int(max(np.floor(self.h - max(y0, y1)), 0))
        r1 = int(min(np.ceil(self.h - min(y0, y1)), self.h))
        if c0 >= c1 or r0 >= r1:
            return
        rows, cols = colors.shape[:2]
        cx = np.arange(c0, c1) + 0.5
        cy = self.h - (np.arange(r0, r1) + 0.5)
        fx = (cx - x0) / (x1 - x0)
        fy = (y1 - cy) / (y1 - y0)  # 0 at the top edge
        if flip_y:
            fy = 1.0 - fy
        okx, oky = (fx >= 0) & (fx < 1), (fy >= 0) & (fy < 1)
        ci = np.clip((fx * cols).astype(int), 0, cols - 1)
        ri = np.clip((fy * rows).astype(int), 0, rows - 1)
        rr, cc = np.meshgrid(np.arange(r0, r1)[oky], np.arange(c0, c1)[okx], indexing="ij")
        col = colors[ri[oky]][:, ci[okx]].reshape(-1, 4)
        self.composite((rr * self.w + cc).ravel(), col)

    def text(self, s, x, y, size_pt, rgba=(0, 0, 0, 1), ha="left", va="baseline",
             rotation=0) -> None:
        """Text at a display point, aligned by `ha` / `va`; `rotation` 90
        turns it to read upwards."""
        mask = text_mask(s, float(self.px(size_pt)))
        if rotation == 90:
            mask = np.rot90(mask)
        h, w = mask.shape
        if w == 0:
            return
        descent = h / 8 if rotation == 0 else 0.0  # the font's 8th row is below the baseline
        left = {"left": x, "center": x - w / 2, "right": x - w}[ha]
        bottom = {"bottom": y, "baseline": y - descent, "center": y - h / 2, "top": y - h}[va]
        rr, cc = np.nonzero(mask)
        dx = np.round(left) + cc + 0.5
        dy = np.round(bottom) + (h - rr) - 0.5
        idx, ok = self.to_index(dx, dy)
        self.coverage(idx[ok], np.ones(int(ok.sum())), rgba)

    def to_uint8(self) -> np.ndarray:
        out = np.full((self.h, self.w, 4), 255, np.uint8)
        out[..., :3] = np.round(np.clip(self.rgb, 0, 1) * 255).reshape(self.h, self.w, 3)
        return out


# ---------------------------------------------------------------- geometry


def grid_positions(box, nrows, ncols, wspace, hspace, width_ratios=None,
                   height_ratios=None):
    """matplotlib's `GridSpec.get_grid_positions` inside a figure-fraction
    box (left, bottom, right, top): (bottoms, tops, lefts, rights)."""
    left, bottom, right, top = box
    cell_h = (top - bottom) / (nrows + hspace * (nrows - 1))
    sep_h = hspace * cell_h
    if height_ratios is not None:
        norm = cell_h * nrows / sum(height_ratios)
        heights = [r * norm for r in height_ratios]
    else:
        heights = [cell_h] * nrows
    cell_hs = np.cumsum(np.column_stack([[0] + [sep_h] * (nrows - 1), heights]).flat)
    cell_w = (right - left) / (ncols + wspace * (ncols - 1))
    sep_w = wspace * cell_w
    if width_ratios is not None:
        norm = cell_w * ncols / sum(width_ratios)
        widths = [r * norm for r in width_ratios]
    else:
        widths = [cell_w] * ncols
    cell_ws = np.cumsum(np.column_stack([[0] + [sep_w] * (ncols - 1), widths]).flat)
    tops, bottoms = (top - cell_hs).reshape((-1, 2)).T
    lefts, rights = (left + cell_ws).reshape((-1, 2)).T
    return bottoms, tops, lefts, rights


def _shrunk_anchored(box, box_aspect, fig_aspect, anchor):
    """`Bbox.shrunk_to_aspect` then `anchored` inside the same box."""
    l, b, r, t = box
    w, h = r - l, t - b
    H = w * box_aspect / fig_aspect
    if H <= h:
        W = w
    else:
        W, H = h * fig_aspect / box_aspect, h
    cx, cy = anchor
    L, B = l + cx * (w - W), b + cy * (h - H)
    return (L, B, L + W, B + H)


def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    """`matplotlib.transforms.nonsingular` (increasing)."""
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        return vmin - expander * abs(vmin), vmax + expander * abs(vmax)
    return vmin, vmax


def autoscale(dmin, dmax, margin, stickies=()):
    """One 2D axis's autoscaled limits (`_AxesBase.autoscale_view`):
    data limits made nonsingular, widened by `margin` of the span on each
    side, never past a sticky edge that the data reach."""
    if not (np.isfinite(dmin) and np.isfinite(dmax)):
        return 0.0, 1.0
    x0, x1 = nonsingular(dmin, dmax, expander=0.05)
    stickies = np.sort(np.asarray(stickies, float))
    tol = 1e-5 * max(abs(x0), abs(x1), abs(x1 - x0))
    i0 = stickies.searchsorted(x0 + tol) - 1
    x0bound = stickies[i0] if i0 != -1 else None
    i1 = stickies.searchsorted(x1 - tol)
    x1bound = stickies[i1] if i1 != len(stickies) else None
    delta = (x1 - x0) * margin
    x0, x1 = x0 - delta, x1 + delta
    if x0bound is not None:
        x0 = max(x0, x0bound)
    if x1bound is not None:
        x1 = min(x1, x1bound)
    return nonsingular(x0, x1)


def autoscale3d(dmin, dmax, margin):
    """One 3D axis's autoscaled limits (`Axes3D.autoscale_view` then
    `set_xbound` with the 1/48 view margin)."""
    x0, x1 = nonsingular(dmin, dmax, expander=0.05)
    if margin > 0:
        delta = (x1 - x0) * margin
        x0, x1 = x0 - delta, x1 + delta
    x0, x1 = nonsingular(x0, x1)
    delta = (x1 - x0) * (1 / 48)
    return x0 - delta, x1 + delta


def nice_ticks(lo, hi, nbins):
    """Ticks at a step of 1, 2, 2.5 or 5 times a power of ten, at most
    `nbins` intervals across [lo, hi]."""
    a, b = min(lo, hi), max(lo, hi)
    if not b > a:
        return np.array([a])
    raw = (b - a) / max(nbins, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = 10 * mag
    for m in (1, 2, 2.5, 5, 10):
        if (b - a) / (m * mag) <= nbins:
            step = m * mag
            break
    first = math.ceil(a / step - 1e-9) * step
    ticks = np.arange(first, b + step * 1e-9, step)
    return np.round(ticks / step) * step


def tick_label(v: float, step: float) -> str:
    """A tick value with as many decimals as the step needs."""
    d = 0
    while d < 10 and abs(step * 10 ** d - round(step * 10 ** d)) > 1e-6 * 10 ** d:
        d += 1
    s = f"{v:.{d}f}"
    return "0" if float(s) == 0 else s


# ---------------------------------------------------------------- artists


class Collection:
    """What `scatter` drew: the markers' data positions, their colors
    before any depth shading (`rgba`, [N, 4]), and, for values mapped
    through a colormap, the `cmap` and `norm` a colorbar reads."""

    def __init__(self, xyz, rgba, size, marker, cmap=None, norm=None, zorder=1):
        self.xyz, self.rgba, self.size, self.marker = xyz, rgba, size, marker
        self.cmap, self.norm, self.zorder = cmap, norm, zorder


def scatter_colors(c, n, cmap=None, vmin=None, vmax=None):
    """(rgba [n, 4], cmap or None, norm or None) for scatter's `c`, by
    matplotlib's rules: a color name, one RGB(A) row, n RGB(A) rows, or n
    numbers mapped through `cmap` (viridis when None) and
    Normalize(vmin, vmax)."""
    if isinstance(c, str):
        return np.tile(to_rgba(c), (n, 1)), None, None
    arr = np.asanyarray(c, dtype=float)
    if arr.shape in ((1, 3), (1, 4)):
        return np.tile(to_rgba_array(arr)[0], (n, 1)), None, None
    if arr.size == n:
        cmap = get_cmap("viridis" if cmap is None else cmap)
        norm = Normalize(vmin, vmax)
        return cmap(norm(arr.ravel())), cmap, norm
    if arr.ndim == 2 and arr.shape[0] == n and arr.shape[1] in (3, 4):
        return to_rgba_array(arr), None, None
    raise ValueError(f"'c' of shape {arr.shape} matches neither {n} values nor {n} colors")


class Axes:
    """A 2D axes: its box in figure fractions, the artists drawn in it and
    the data limits they span."""

    name = "rectilinear"

    def __init__(self, figure, box):
        self.figure = figure
        self._box = tuple(box)  # left, bottom, right, top (figure fraction)
        self._anchor = (0.5, 0.5)
        self._aspect = "auto"
        self._box_aspect = None
        self._artists = []  # (zorder, order added, draw callable(raster, axes))
        self.collections = []  # what scatter drew, in order
        self._lim = [None, None]
        self._data = np.array([[np.inf, -np.inf], [np.inf, -np.inf]])
        self._sticky = ([], [])
        self._inverted_y = False
        self._ticks = [None, None]
        self._labels = ["", ""]
        self._title = ""
        self._axis_on = True
        self._colorbar = None

    # ---- limits
    def _update_data(self, xs, ys):
        xs, ys = np.asarray(xs, float).ravel(), np.asarray(ys, float).ravel()
        ok = np.isfinite(xs) & np.isfinite(ys)
        if ok.any():
            self._data[0] = min(self._data[0, 0], xs[ok].min()), max(self._data[0, 1], xs[ok].max())
            self._data[1] = min(self._data[1, 0], ys[ok].min()), max(self._data[1, 1], ys[ok].max())

    def _get_lim(self, i):
        if self._lim[i] is not None:
            return self._lim[i]
        lo, hi = autoscale(*self._data[i], 0.05, self._sticky[i])
        return (hi, lo) if (i == 1 and self._inverted_y) else (lo, hi)

    def get_xlim(self):
        return tuple(float(v) for v in self._get_lim(0))

    def get_ylim(self):
        return tuple(float(v) for v in self._get_lim(1))

    def set_xlim(self, left, right=None):
        left, right = (left if right is None else (left, right))
        self._lim[0] = (float(left), float(right))

    def set_ylim(self, bottom, top=None):
        bottom, top = (bottom if top is None else (bottom, top))
        self._lim[1] = (float(bottom), float(top))

    def set_axis_off(self):
        self._axis_on = False

    def set_xlabel(self, s):
        self._labels[0] = s

    def set_ylabel(self, s):
        self._labels[1] = s

    def set_title(self, s):
        self._title = s

    def set_xticks(self, ticks, labels=None, rotation=0):
        ticks = [float(t) for t in ticks]
        self._ticks[0] = (ticks, None if labels is None else [str(s) for s in labels])

    def set_yticks(self, ticks, labels=None):
        ticks = [float(t) for t in ticks]
        self._ticks[1] = (ticks, None if labels is None else [str(s) for s in labels])

    # ---- geometry
    def _fig_aspect(self):
        w, h = self.figure.figsize
        return h / w

    def get_position(self):
        """The active box (left, bottom, right, top) in figure fractions,
        after the aspect is applied."""
        if self._box_aspect is not None:
            return _shrunk_anchored(self._box, self._box_aspect, self._fig_aspect(),
                                    self._anchor)
        if self._aspect == "equal":
            (x0, x1), (y0, y1) = self.get_xlim(), self.get_ylim()
            ratio = max(abs(y1 - y0), 1e-30) / max(abs(x1 - x0), 1e-30)
            return _shrunk_anchored(self._box, ratio, self._fig_aspect(), self._anchor)
        return self._box

    def _display_box(self, dpi):
        l, b, r, t = self.get_position()
        w, h = self.figure.figsize
        return l * w * dpi, b * h * dpi, r * w * dpi, t * h * dpi

    def _view(self):
        return self.get_xlim(), self.get_ylim()

    def transform(self, xy, dpi=None) -> np.ndarray:
        """Display pixels (x right, y up from the figure's bottom edge) of
        [N, 2] data points, at `dpi` (the figure's when None)."""
        dpi = self.figure.dpi if dpi is None else dpi
        xy = np.asarray(xy, float).reshape(-1, 2)
        (x0, x1), (y0, y1) = self._view()
        l, b, r, t = self._display_box(dpi)
        return np.column_stack([l + (xy[:, 0] - x0) / (x1 - x0) * (r - l),
                                b + (xy[:, 1] - y0) / (y1 - y0) * (t - b)])

    def _axes_point(self, fx, fy, dpi):
        l, b, r, t = self._display_box(dpi)
        return l + fx * (r - l), b + fy * (t - b)

    # ---- artists
    def _add(self, zorder, fn):
        self._artists.append((zorder, len(self._artists), fn))

    def scatter(self, x, y, s=20, c=None, cmap=None, vmin=None, vmax=None, marker="o",
                zorder=1):
        x, y = np.asarray(x, float).ravel(), np.asarray(y, float).ravel()
        rgba, cmap, norm = scatter_colors(c, x.size, cmap, vmin, vmax)
        col = Collection(np.column_stack([x, y]), rgba, float(s), marker, cmap, norm, zorder)
        self.collections.append(col)
        self._update_data(x, y)

        def draw(raster, ax):
            pts = ax.transform(col.xyz, raster.dpi)
            _markers(raster, pts[:, 0], pts[:, 1], col.size, col.marker, col.rgba)
        self._add(zorder, draw)
        return col

    def plot_segments(self, x0, y0, x1, y1, color=DEFAULT_CYCLE, linewidth=1.5,
                      zorder=2):
        """Line segments (x0, y0) -> (x1, y1), one artist drawn in one
        pass; the limits grow as for one `plot` a segment."""
        x0, y0, x1, y1 = (np.asarray(v, float).ravel() for v in (x0, y0, x1, y1))
        self._update_data(np.r_[x0, x1], np.r_[y0, y1])
        rgba = to_rgba(color)

        def draw(raster, ax):
            p0 = ax.transform(np.column_stack([x0, y0]), raster.dpi)
            p1 = ax.transform(np.column_stack([x1, y1]), raster.dpi)
            raster.segments(p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1],
                            float(raster.px(linewidth)), rgba)
        self._add(zorder, draw)

    def bar(self, x, height, width=0.8, color=DEFAULT_CYCLE):
        x = np.asarray(x, float).ravel()
        height = np.asarray(height, float).ravel()
        left = x - width / 2
        right = width + left
        self._update_data(np.r_[left, right], np.r_[np.zeros_like(height), height])
        self._sticky[1].extend([0.0] * x.size)
        rgba = to_rgba(color)

        def draw(raster, ax):
            p0 = ax.transform(np.column_stack([left, np.zeros_like(height)]), raster.dpi)
            p1 = ax.transform(np.column_stack([right, height]), raster.dpi)
            for (a, b), (c, d) in zip(p0, p1):
                raster.rect(a, b, c, d, rgba)
        self._add(1, draw)

    def imshow(self, img, cmap=None, vmin=None, vmax=None, aspect="equal"):
        """A 2D array through `cmap`, pixel (i, j) centred on data (j, i),
        row 0 at the top."""
        img = np.asarray(img, float)
        rows, cols = img.shape
        cmap = get_cmap("viridis" if cmap is None else cmap)
        norm = Normalize(vmin, vmax)
        colors = cmap(norm(img.ravel())).reshape(rows, cols, 4)
        ext = (-0.5, cols - 0.5, rows - 0.5, -0.5)
        self._update_data([ext[0], ext[1]], [ext[2], ext[3]])
        self._sticky[0].extend([ext[0], ext[1]])
        self._sticky[1].extend([ext[3], ext[2]])
        self._inverted_y = True
        self._aspect = "equal" if aspect == "equal" else "auto"

        def draw(raster, ax):
            (a, b), (c, d) = ax.transform([[ext[0], ext[3]], [ext[1], ext[2]]], raster.dpi)
            raster.image((a, d, c, b), colors, flip_y=False)
        self._add(0, draw)
        return Collection(None, colors, None, None, cmap, norm, 0)

    def text(self, x, y, s, ha="left", va="baseline", color="k", fontsize=10,
             coords="data"):
        rgba = to_rgba(color)

        def draw(raster, ax):
            if coords == "data":
                (px, py), = ax.transform([[x, y]], raster.dpi)
            else:
                px, py = ax._axes_point(x, y, raster.dpi)
            raster.text(s, px, py, fontsize, rgba, ha, va)
        self._add(3, draw)

    def annotate(self, text, xy, xycoords="data", fontsize=10):
        self.text(xy[0], xy[1], text, fontsize=fontsize,
                  coords="axes" if xycoords == "axes fraction" else "data")

    # ---- drawing
    def draw(self, raster):
        for _, _, fn in sorted(self._artists, key=lambda a: a[:2]):
            fn(raster, self)
        if self._axis_on:
            self._draw_axis(raster)
        if self._title:
            x, y = self._axes_point(0.5, 1.0, raster.dpi)
            raster.text(self._title, x, y + float(raster.px(6)), 12, ha="center",
                        va="baseline")

    def _tick_set(self, i, length_px, dpi):
        lim = self._get_lim(i)
        if self._ticks[i] is not None:
            ticks, labels = self._ticks[i]
            ticks = np.asarray(ticks)
            step = np.min(np.diff(np.sort(ticks))) if len(ticks) > 1 else 1.0
        else:
            space = length_px * 72 / dpi / (10 * (3 if i == 0 else 2))
            ticks = nice_ticks(lim[0], lim[1], int(max(min(space, 9), 1)))
            labels = None
            step = ticks[1] - ticks[0] if len(ticks) > 1 else 1.0
        lo, hi = min(lim), max(lim)
        keep = (ticks >= lo - 1e-9 * (hi - lo)) & (ticks <= hi + 1e-9 * (hi - lo))
        labels = [tick_label(v, step) for v in ticks] if labels is None else labels
        return ticks[keep], [lab for lab, k in zip(labels, keep) if k]

    def _draw_axis(self, raster):
        l, b, r, t = self._display_box(raster.dpi)
        lw = float(raster.px(0.8))
        black = (0, 0, 0, 1)
        raster.segments([l, r, l, l], [b, b, b, t], [r, r, l, r], [b, t, t, t], lw, black)
        tick, pad = float(raster.px(3.5)), float(raster.px(3.5))
        xt, xl = self._tick_set(0, r - l, raster.dpi)
        if len(xt):
            px = self.transform(np.column_stack([xt, np.zeros_like(xt)]), raster.dpi)[:, 0]
            raster.segments(px, np.full_like(px, b), px, np.full_like(px, b - tick), lw, black)
            for x, s in zip(px, xl):
                raster.text(s, x, b - tick - pad, 10, ha="center", va="top")
        yt, yl = self._tick_set(1, t - b, raster.dpi)
        width = 0.0
        if len(yt):
            py = self.transform(np.column_stack([np.zeros_like(yt), yt]), raster.dpi)[:, 1]
            raster.segments(np.full_like(py, l), py, np.full_like(py, l - tick), py, lw, black)
            for y, s in zip(py, yl):
                raster.text(s, l - tick - pad, y, 10, ha="right", va="center")
                width = max(width, text_mask(s, float(raster.px(10))).shape[1])
        size = float(raster.px(10))
        if self._labels[0]:
            raster.text(self._labels[0], (l + r) / 2, b - tick - 2 * pad - size, 10,
                        ha="center", va="top")
        if self._labels[1]:
            raster.text(self._labels[1], l - tick - 2 * pad - width, (b + t) / 2, 10,
                        ha="right", va="center", rotation=90)


def _markers(raster, x, y, size, marker, rgba):
    """Scatter markers at display points, drawn in order: a disc of
    diameter sqrt(size) pt plus its 1.5 pt edge for 'o', two strokes of
    1.5 pt for 'x'."""
    half = float(raster.px(math.sqrt(size) / 2))
    if marker == "x":
        lw = float(raster.px(1.5))
        for (px, py), col in zip(np.column_stack([x, y]), rgba):
            raster.segments([px - half, px - half], [py - half, py + half],
                            [px + half, px + half], [py + half, py - half], lw, col)
        return
    raster.discs(x, y, half + float(raster.px(0.75)), rgba)


class Axes3D(Axes):
    """A 3D axes at matplotlib's default view; its box is made square."""

    name = "3d"

    def __init__(self, figure, box):
        super().__init__(figure, box)
        self._data3 = np.array([[np.inf, -np.inf]] * 3)
        self._lim3 = [None, None, None]
        self._zmargin = 0.0
        self.set_box_aspect(None)

    def set_box_aspect(self, aspect):
        aspect = np.asarray((4, 4, 3) if aspect is None else aspect, dtype=float)
        aspect *= 1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect)
        self._aspect3 = aspect

    def _update_data3(self, xs, ys, zs):
        if np.size(xs) == 0:
            return
        first = not np.isfinite(self._data3).all()
        for i, v in enumerate((xs, ys, zs)):
            v = np.asarray(v, float).ravel()
            lo, hi = v.min(), v.max()
            if first:
                self._data3[i] = lo, hi
            else:
                self._data3[i] = min(self._data3[i, 0], lo), max(self._data3[i, 1], hi)

    def _get_lim3(self, i):
        if self._lim3[i] is not None:
            return self._lim3[i]
        if not np.isfinite(self._data3[i]).all():
            return autoscale3d(0.05 * 10 / 11, 1 - 0.05 * 10 / 11, 0.05 if i < 2 else 0.0)
        return autoscale3d(*self._data3[i], 0.05 if i < 2 else self._zmargin)

    def get_xlim(self):
        return tuple(float(v) for v in self._get_lim3(0))

    def get_ylim(self):
        return tuple(float(v) for v in self._get_lim3(1))

    def get_zlim(self):
        return tuple(float(v) for v in self._get_lim3(2))

    get_xlim3d, get_ylim3d, get_zlim3d = get_xlim, get_ylim, get_zlim

    def set_xlim(self, left, right=None):
        self._lim3[0] = tuple(float(v) for v in (left if right is None else (left, right)))

    def set_ylim(self, bottom, top=None):
        self._lim3[1] = tuple(float(v) for v in (bottom if top is None else (bottom, top)))

    def set_zlim(self, bottom, top=None):
        self._lim3[2] = tuple(float(v) for v in (bottom if top is None else (bottom, top)))

    def get_position(self):
        return _shrunk_anchored(self._box, 1.0, self._fig_aspect(), self._anchor)

    def _view(self):
        return _VIEW2D, _VIEW2D

    def get_proj(self) -> np.ndarray:
        """The 4 x 4 projection matrix of `Axes3D.get_proj` at the default
        view (elev 30, azim -60, roll 0, perspective, focal length 1)."""
        box = self._aspect3
        (x0, x1), (y0, y1), (z0, z1) = self.get_xlim(), self.get_ylim(), self.get_zlim()
        dx, dy, dz = (x1 - x0) / box[0], (y1 - y0) / box[1], (z1 - z0) / box[2]
        world = np.array([[1 / dx, 0, 0, -x0 / dx], [0, 1 / dy, 0, -y0 / dy],
                          [0, 0, 1 / dz, -z0 / dz], [0, 0, 0, 1]])
        R = 0.5 * box
        elev, azim = np.deg2rad(30.0), np.deg2rad(-60.0)
        ps = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)])
        eye = R + 10 * ps
        w = (eye - R) / np.linalg.norm(eye - R)
        u = np.cross(np.array([0.0, 0.0, 1.0]), w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        Mr, Mt = np.eye(4), np.eye(4)
        Mr[:3, :3] = [u, v, w]
        Mt[:3, -1] = -(R + 10 * ps * 1.0)
        view = np.dot(Mr, Mt)
        zf, zb = -10.0, 10.0
        proj = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                         [0, 0, (zf + zb) / (zf - zb), -2 * (zf * zb) / (zf - zb)],
                         [0, 0, -1, 0]])
        return np.dot(proj, np.dot(view, world))

    def project(self, xs, ys, zs):
        """(x, y, depth) of data points in the projected 2D view
        (`proj3d.proj_transform` with `get_proj()`)."""
        vec = np.array([np.ravel(xs), np.ravel(ys), np.ravel(zs), np.ones(np.size(xs))], float)
        out = np.dot(self.get_proj(), vec)
        return out[0] / out[3], out[1] / out[3], out[2] / out[3]

    def scatter(self, xs, ys, zs=0, s=20, c=None, cmap=None, vmin=None, vmax=None,
                marker="o", depthshade=True):
        xs, ys = np.asarray(xs, float).ravel(), np.asarray(ys, float).ravel()
        zs = np.broadcast_to(np.asarray(zs, float), xs.shape).ravel()
        rgba, cmap, norm = scatter_colors(c, xs.size, cmap, vmin, vmax)
        col = Collection(np.column_stack([xs, ys, zs]), rgba, float(s), marker, cmap, norm)
        self.collections.append(col)
        if xs.size and self._zmargin < 0.05:
            self._zmargin = 0.05
        self._update_data3(xs, ys, zs)

        def draw(raster, ax):
            vx, vy, vz = ax.project(*col.xyz.T)
            order = np.argsort(vz)[::-1]  # far to near
            colors = col.rgba.copy()
            if depthshade and vz.size:
                span = vz.max() - vz.min()
                depth = (vz - vz.min()) / span if span > 0 else np.zeros_like(vz)
                colors[:, 3] *= 1 - depth * 0.7
            pts = ax.transform(np.column_stack([vx, vy]), raster.dpi)
            _markers(raster, pts[order, 0], pts[order, 1], col.size, col.marker, colors[order])
        self._add(1, draw)
        return col

    def plot_wireframe(self, X, Y, Z, color=DEFAULT_CYCLE, alpha=1.0, linewidth=1.5):
        """Lines along the rows and the columns of a [m, n] mesh."""
        X, Y, Z = (np.asarray(v, float) for v in (X, Y, Z))
        self._update_data3(X, Y, Z)
        rgba = to_rgba(color, alpha)
        a = np.stack([X, Y, Z], -1)
        starts = np.concatenate([a[:, :-1].reshape(-1, 3), a[:-1, :].reshape(-1, 3)])
        ends = np.concatenate([a[:, 1:].reshape(-1, 3), a[1:, :].reshape(-1, 3)])

        def draw(raster, ax):
            p0 = ax.transform(np.column_stack(ax.project(*starts.T)[:2]), raster.dpi)
            p1 = ax.transform(np.column_stack(ax.project(*ends.T)[:2]), raster.dpi)
            raster.segments(p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1],
                            float(raster.px(linewidth)), rgba)
        self._add(1, draw)

    def _draw_axis(self, raster):
        """The three back panes of the data box, each filled light gray
        with a gray edge."""
        lims = [self.get_xlim(), self.get_ylim(), self.get_zlim()]
        corners = np.array([[lims[0][i], lims[1][j], lims[2][k]]
                            for i in (0, 1) for j in (0, 1) for k in (0, 1)])
        vx, vy, vz = self.project(*corners.T)
        pts = self.transform(np.column_stack([vx, vy]), raster.dpi)
        faces = []
        for axis in range(3):
            for side in (0, 1):
                ids = [n for n in range(8) if (n >> (2 - axis)) & 1 == side]
                faces.append((vz[ids].mean(), ids))
        for axis in range(3):
            near, far = faces[2 * axis], faces[2 * axis + 1]
            _, ids = max(near, far)  # the pane farther from the camera
            a, b, c, d = ids[0], ids[1], ids[3], ids[2]
            xs, ys = pts[[a, b, c, d], 0], pts[[a, b, c, d], 1]
            raster.polygon(xs, ys, PANE_RGBA)
            raster.segments(xs, ys, np.roll(xs, -1), np.roll(ys, -1), float(raster.px(0.8)),
                            (0.5, 0.5, 0.5, 1.0))


class Colorbar:
    """A vertical colorbar on the right of its parent axes: the colormap's
    N colors in N equal bands from vmin to vmax, ticks and a label."""

    def __init__(self, cax: "ColorbarAxes", ticks=None, label=""):
        self.ax, self.ticks, self.label = cax, ticks, label

    def set_label(self, label):
        self.label = label


class ColorbarAxes(Axes):
    def __init__(self, figure, box, cmap: Colormap, norm: Normalize):
        super().__init__(figure, box)
        self.cmap, self.norm = cmap, norm
        self._anchor = (0.0, 0.5)
        self._box_aspect = 20.0
        self.colorbar = None

    def draw(self, raster):
        vmin, vmax = self.norm.vmin, self.norm.vmax
        if vmin is None or vmax is None:
            vmin, vmax = 0.0, 1.0
        l, b, r, t = self._display_box(raster.dpi)
        colors = self.cmap.colors[::-1][:, None, :]
        raster.image((l, b, r, t), colors, flip_y=False)
        lw = float(raster.px(0.8))
        raster.segments([l, r, r, l], [b, b, t, t], [r, r, l, l], [b, t, t, b], lw, (0, 0, 0, 1))
        cb = self.colorbar
        if cb.ticks is not None:
            ticks = np.asarray(list(cb.ticks), float)
            step = np.min(np.diff(ticks)) if ticks.size > 1 else 1.0
        else:
            space = (t - b) * 72 / raster.dpi / 20
            ticks = nice_ticks(vmin, vmax, int(max(min(space, 9), 1)))
            step = ticks[1] - ticks[0] if ticks.size > 1 else 1.0
        span = (vmax - vmin) or 1.0
        ticks = ticks[(ticks >= min(vmin, vmax) - 1e-9) & (ticks <= max(vmin, vmax) + 1e-9)]
        ys = b + (ticks - vmin) / span * (t - b)
        tick, pad = float(raster.px(3.5)), float(raster.px(3.5))
        raster.segments(np.full_like(ys, r), ys, np.full_like(ys, r + tick), ys, lw, (0, 0, 0, 1))
        width = 0
        for y, v in zip(ys, ticks):
            s = tick_label(v, step)
            raster.text(s, r + tick + pad, y, 10, ha="left", va="center")
            width = max(width, text_mask(s, float(raster.px(10))).shape[1])
        if cb.label:
            raster.text(cb.label, r + tick + 2 * pad + width, (b + t) / 2, 10, ha="left",
                        va="center", rotation=90)


class Figure:
    """A figure of `figsize` inches; `dpi` sets the pixels of `draw()`
    and of the positions `Axes.transform` returns."""

    def __init__(self, figsize=(6.4, 4.8), dpi=100.0, layout=None):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self.axes = []
        self._suptitle = ""
        self._layout = layout
        self.buffer = None

    def add_subplot(self, *args, projection=None):
        """`add_subplot(111)` or `add_subplot(nrows, ncols, index)`."""
        if len(args) == 1:
            nrows, ncols, index = (int(d) for d in str(args[0]))
        else:
            nrows, ncols, index = args
        box = self._cell(nrows, ncols, index - 1)
        ax = (Axes3D if projection == "3d" else Axes)(self, box)
        self.axes.append(ax)
        return ax

    def _cell(self, nrows, ncols, k):
        p = SUBPLOT
        if self._layout == "constrained":
            p = dict(left=0.07, right=0.98, bottom=0.07, top=0.9, wspace=0.1, hspace=0.45)
        b, t, l, r = grid_positions((p["left"], p["bottom"], p["right"], p["top"]),
                                    nrows, ncols, p["wspace"], p["hspace"])
        i, j = divmod(k, ncols)
        return (l[j], b[i], r[j], t[i])

    def subplots(self, nrows=1, ncols=1, squeeze=True):
        axes = np.empty((nrows, ncols), dtype=object)
        for k in range(nrows * ncols):
            axes[k // ncols, k % ncols] = self.add_subplot(nrows, ncols, k + 1)
        if squeeze and nrows == ncols == 1:
            return axes[0, 0]
        return axes

    def suptitle(self, s):
        self._suptitle = s

    def colorbar(self, mappable, ax, fraction=0.15, pad=0.05, ticks=None, label=""):
        """A colorbar beside `ax` for a mapped scatter or image: the parent's
        box is split as matplotlib's `make_axes_gridspec` splits it."""
        if mappable.cmap is None:
            raise ValueError("colorbar needs values mapped through a colormap")
        wh_space = 2 * pad / (1 - pad)
        b, t, l, r = grid_positions((ax._box[0], ax._box[1], ax._box[2], ax._box[3]), 3, 2,
                                    wh_space, 0, width_ratios=[1 - fraction - pad, fraction],
                                    height_ratios=[0.0, 1.0, 0.0])
        ax._box = (l[0], b[2], r[0], t[0])
        ax._anchor = (1.0, 0.5)
        cax = ColorbarAxes(self, (l[1], b[1], r[1], t[1]), mappable.cmap, mappable.norm)
        cax.colorbar = Colorbar(cax, ticks, label)
        self.axes.append(cax)
        return cax.colorbar

    def pixel_size(self, dpi=None):
        dpi = self.dpi if dpi is None else dpi
        return int(self.figsize[0] * dpi), int(self.figsize[1] * dpi)  # Agg truncates

    def draw(self, dpi=None) -> np.ndarray:
        """Rasterize at `dpi` (the figure's when None) into `self.buffer`,
        [H, W, 4] uint8, and return it."""
        dpi = self.dpi if dpi is None else float(dpi)
        w, h = self.pixel_size(dpi)
        raster = Raster(w, h, dpi)
        for ax in self.axes:
            ax.draw(raster)
        if self._suptitle:
            raster.text(self._suptitle, w / 2, h - float(raster.px(6)), 12, ha="center",
                        va="top")
        self.buffer = raster.to_uint8()
        return self.buffer

    def to_rgba(self, dpi=150, bbox_inches="tight") -> np.ndarray:
        """What `savefig` writes: the figure at `dpi`, cropped to what was
        drawn plus 0.1 inch when `bbox_inches` is "tight"."""
        img = self.draw(dpi)
        if bbox_inches != "tight":
            return img
        drawn = (img[..., :3] != 255).any(-1)
        if not drawn.any():
            return img
        rows, cols = np.flatnonzero(drawn.any(1)), np.flatnonzero(drawn.any(0))
        pad = int(round(0.1 * dpi))
        r0, r1 = rows[0] - pad, rows[-1] + 1 + pad
        c0, c1 = cols[0] - pad, cols[-1] + 1 + pad
        out = np.full((r1 - r0, c1 - c0, 4), 255, np.uint8)
        sr0, sc0 = max(r0, 0), max(c0, 0)
        sr1, sc1 = min(r1, img.shape[0]), min(c1, img.shape[1])
        out[sr0 - r0:sr1 - r0, sc0 - c0:sc1 - c0] = img[sr0:sr1, sc0:sc1]
        return out

    def savefig(self, path, dpi=150, bbox_inches="tight"):
        """Write the figure as PNG; another extension raises ValueError."""
        ext = os.path.splitext(str(path))[1].lower()
        if ext != ".png":
            raise ValueError(f"only PNG is written (no vector backend), not {ext!r}")
        write_png(str(path), self.to_rgba(dpi, bbox_inches))


def figure(figsize=(6.4, 4.8), dpi=100.0, layout=None) -> Figure:
    return Figure(figsize, dpi, layout)


def subplots(nrows=1, ncols=1, figsize=(6.4, 4.8), squeeze=True, layout=None):
    fig = Figure(figsize, layout=layout)
    return fig, fig.subplots(nrows, ncols, squeeze)


def check_fmt(fmt: str) -> None:
    """The port writes PNG only: it has no vector backend."""
    if fmt != "png":
        raise ValueError(f"fmt={fmt!r}: the port's figures are written as PNG only "
                         "(no vector backend)")
