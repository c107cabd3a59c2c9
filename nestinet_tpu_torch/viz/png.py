"""PNG write and read in NumPy and the standard library (`zlib`, `struct`).

`write_png` writes what the port's figures need, 8-bit RGBA in one IDAT
chunk, every row with filter 0 (None), compressed at zlib level 6.
`read_png` reads non-interlaced grayscale, RGB and RGBA files of bit depth
8 or 16 with any of the five row filters (PNG spec, section 9), and checks
the CRC of every chunk.  A palette, gray+alpha, bit depths below 8 and
interlaced files raise ValueError naming what they are.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples a pixel: gray, RGB, RGBA
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write an [H, W, 4] uint8 RGBA image as an 8-bit RGBA PNG."""
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"write_png wants [H, W, 4] uint8, got {rgba.shape} {rgba.dtype}")
    h, w, _ = rgba.shape
    rows = np.zeros((h, 1 + 4 * w), np.uint8)  # filter byte 0 (None) on every row
    rows[:, 1:] = rgba.reshape(h, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
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


def read_header(path: str) -> tuple[int, int, int, int, int]:
    """(width, height, bit depth, color type, interlace) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", head[16:29])
    return w, h, depth, color, interlace


def read_png(path: str) -> np.ndarray:
    """Pixels of a non-interlaced gray ([H, W]), RGB ([H, W, 3]) or RGBA
    ([H, W, 4]) PNG: uint8 at bit depth 8, uint16 at 16 (big-endian in the
    file).  Any other kind, and a chunk whose CRC does not match, raise
    ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
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
    if color not in _CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(
            f"{path}: only non-interlaced gray, RGB and RGBA PNGs of 8 or 16 bits are "
            f"read (this one: {_COLOR_NAMES.get(color, color)}, bit depth {depth}, "
            f"interlace {interlace})")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {height} rows")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    pixels = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = pixels[y] = unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)
