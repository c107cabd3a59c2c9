"""A read-only HDF5 reader in NumPy and `zlib`, for the files h5py writes
with its default (earliest) file format, as PointNet's `save_h5` wrote
ModelNet40's `ply_data_*.h5`.

Supported: superblock versions 0 and 1 (after a user block or not);
version-1 object headers with continuation messages; symbol-table groups
(v1 B-tree type 0, SNOD nodes, the local heap), nested paths included;
dataspace versions 1 and 2 (scalar and simple); datatype class 0 (1-, 2-,
4- and 8-byte integers, signed or not) and class 1 (IEEE 4- and 8-byte
floats), either byte order; data layout version 3: compact, contiguous,
and chunked through v1 B-tree type 1 nodes, edge chunks cropped,
unallocated chunks and an undefined address giving the fill value; filter
pipeline versions 1 and 2 with deflate (1) and shuffle (2).  Anything else
raises NotImplementedError naming the feature: superblock versions 2 and 3
(h5py's `libver="latest"`), version-2 object headers and link messages,
fletcher32, szip, lzf or any other filter, variable-length, string,
compound and the other datatype classes.

    with File(path) as f:
        data = f["data"][:]
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                 32000: "lzf", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle"}
_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
_MSG_LINK_INFO, _MSG_LINK, _MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0x02, 0x06, 0x10, 0x11


class _Reader:
    """Little-endian fields of the file at absolute offsets."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.size_o = self.size_l = 8
        self.base = 0

    def uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.size_o)) - 1


class Dataset:
    """One dataset: `shape`, `dtype`, and its values through `ds[...]`."""

    def __init__(self, reader: _Reader, name: str, messages: list):
        self._r, self.name = reader, name
        self.shape = self.dtype = self._layout = None
        self._filters, self._fill = [], None
        for mtype, body in messages:
            if mtype == 0x01:
                self.shape = _dataspace(body, reader)
            elif mtype == 0x03:
                self.dtype = _datatype(body, name)
            elif mtype == 0x04:
                (size,) = struct.unpack_from("<I", body, 0)
                self._fill = body[4:4 + size] if size else None
            elif mtype == 0x05:
                self._fill = _fill_value(body, name)
            elif mtype == 0x08:
                self._layout = body
            elif mtype == 0x0B:
                self._filters = _filter_pipeline(body, name)
        if self.shape is None or self.dtype is None or self._layout is None:
            raise NotImplementedError(f"{name}: an object with no dataspace, datatype or "
                                      "layout message")

    def __getitem__(self, key):
        return self.read()[key]

    def read(self) -> np.ndarray:
        """The whole dataset as an array of its dtype (in its byte order)."""
        r, body = self._r, self._layout
        version, kind = body[0], body[1]
        if version != 3:
            raise NotImplementedError(f"{self.name}: data layout message version {version} "
                                      "(only version 3 is read)")
        count = int(np.prod(self.shape, dtype=np.int64))
        nbytes = count * self.dtype.itemsize
        if kind == 0:  # compact: the raw data in the message
            (size,) = struct.unpack_from("<H", body, 2)
            return np.frombuffer(body[4:4 + size], self.dtype, count).reshape(self.shape).copy()
        if kind == 1:  # contiguous
            addr = int.from_bytes(body[2:2 + r.size_o], "little")
            if r.undefined(addr):
                return self._filled()
            pos = r.base + addr
            return np.frombuffer(r.buf[pos:pos + nbytes], self.dtype, count).reshape(
                self.shape).copy()
        if kind == 2:
            return self._read_chunked(body)
        raise NotImplementedError(f"{self.name}: data layout class {kind}")

    def _filled(self) -> np.ndarray:
        out = np.zeros(self.shape, self.dtype)
        if self._fill is not None and len(self._fill) == self.dtype.itemsize:
            out[...] = np.frombuffer(self._fill, self.dtype, 1)[0]
        return out

    def _read_chunked(self, body: bytes) -> np.ndarray:
        r = self._r
        ndim = body[2]  # the dataset's rank + 1 (the element)
        btree = int.from_bytes(body[3:3 + r.size_o], "little")
        pos = 3 + r.size_o
        dims = struct.unpack_from(f"<{ndim}I", body, pos)
        chunk, elem = tuple(dims[:-1]), dims[-1]
        if elem != self.dtype.itemsize or len(chunk) != len(self.shape):
            raise NotImplementedError(f"{self.name}: chunk dims {dims} for shape "
                                      f"{self.shape} of {self.dtype}")
        out = self._filled()
        if r.undefined(btree):
            return out
        csize = int(np.prod(chunk, dtype=np.int64))
        for offset, addr, size, mask in _chunk_btree(r, btree, ndim, self.name):
            raw = r.buf[r.base + addr:r.base + addr + size]
            for i in reversed(range(len(self._filters))):
                if not mask >> i & 1:
                    raw = _unfilter(self._filters[i], raw)
            if len(raw) != csize * elem:
                raise ValueError(f"{self.name}: a chunk of {len(raw)} bytes, not "
                                 f"{csize * elem}")
            block = np.frombuffer(raw, self.dtype, csize).reshape(chunk)
            sel = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, self.shape))
            out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
        return out


class Group:
    """A symbol-table group: its members by name (`keys()`, `g[name]`,
    paths with '/')."""

    def __init__(self, reader: _Reader, name: str, messages: list):
        self._r, self.name = reader, name
        table = [body for mtype, body in messages if mtype == _MSG_SYMBOL_TABLE]
        if not table:
            raise NotImplementedError(f"{name}: a group without a symbol table (link "
                                      "messages of the newer group format)")
        so = reader.size_o
        self._btree = int.from_bytes(table[0][:so], "little")
        heap = int.from_bytes(table[0][so:2 * so], "little")
        self._members = dict(_group_entries(reader, self._btree, heap))

    def keys(self):
        return list(self._members)

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._members:
                raise KeyError(f"{path!r} not in {self.name!r}")
            child = node.name.rstrip("/") + "/" + part
            node = _open(node._r, node._members[part], child)
        return node


class File(Group):
    """An HDF5 file opened for reading (the whole file is read into memory)."""

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise ValueError("the reader opens files read-only (mode 'r')")
        with open(path, "rb") as f:
            buf = f.read()
        pos = buf.find(SIGNATURE)
        while pos > 0 and pos % 512:  # the superblock sits at 0, 512, 1024, ...
            pos = buf.find(SIGNATURE, pos + 1)
        if pos < 0:
            raise ValueError(f"{path}: not an HDF5 file")
        r = _Reader(buf)
        version = buf[pos + 8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{path}: superblock version {version} (written with libver='latest' or "
                "'v108'+); only versions 0 and 1, h5py's default, are read")
        r.size_o, r.size_l = buf[pos + 13], buf[pos + 14]
        r.base = pos  # addresses count from the superblock, as the HDF5 library reads them
        # the root group's entry follows the base, free-space, end-of-file
        # and driver-block addresses
        root = pos + 24 + (4 if version == 1 else 0) + 4 * r.size_o
        header = r.uint(root + r.size_o, r.size_o)
        super().__init__(r, "/", _object_messages(r, header, "/"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._r.buf = b""


# ---------------------------------------------------------------- structures


def _open(r: _Reader, header: int, name: str):
    messages = _object_messages(r, header, name)
    types = {m for m, _ in messages}
    if _MSG_SYMBOL_TABLE in types:
        return Group(r, name, messages)
    if types & {_MSG_LINK_INFO, _MSG_LINK}:
        raise NotImplementedError(f"{name}: link messages (a group of the newer format)")
    return Dataset(r, name, messages)


def _object_messages(r: _Reader, header: int, name: str) -> list:
    """[(type, body)] of a version-1 object header, its continuation
    blocks followed."""
    pos = r.base + header
    if r.buf[pos:pos + 4] == b"OHDR":
        raise NotImplementedError(f"{name}: a version 2 object header "
                                  "(written with libver='latest' or 'v108'+)")
    if r.buf[pos] != 1:
        raise NotImplementedError(f"{name}: object header version {r.buf[pos]}")
    (count,) = struct.unpack_from("<H", r.buf, pos + 2)
    (size,) = struct.unpack_from("<I", r.buf, pos + 8)
    blocks, messages = [(pos + 16, size)], []
    while blocks and len(messages) < count:
        start, length = blocks.pop(0)
        p = start
        while p + 8 <= start + length and len(messages) < count:
            mtype, msize = struct.unpack_from("<HH", r.buf, p)
            body = r.buf[p + 8:p + 8 + msize]
            p += 8 + msize
            if mtype == _MSG_CONTINUATION:
                addr = int.from_bytes(body[:r.size_o], "little")
                clen = int.from_bytes(body[r.size_o:r.size_o + r.size_l], "little")
                blocks.append((r.base + addr, clen))
            messages.append((mtype, body))
    return messages


def _dataspace(body: bytes, r: _Reader) -> tuple:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise NotImplementedError("a null dataspace")
        pos = 4
    else:
        raise NotImplementedError(f"dataspace message version {version}")
    return tuple(int.from_bytes(body[pos + i * r.size_l:pos + (i + 1) * r.size_l], "little")
                 for i in range(rank))


def _datatype(body: bytes, name: str) -> np.dtype:
    cls, bits = body[0] & 0x0F, body[1]
    (size,) = struct.unpack_from("<I", body, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0 and size in (1, 2, 4, 8):
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8) and not bits & 0x40:
        return np.dtype(f"{order}f{size}")
    what = _CLASS_NAMES.get(cls, f"class {cls}")
    raise NotImplementedError(f"{name}: datatype {what} of {size} bytes")


def _fill_value(body: bytes, name: str) -> bytes | None:
    version = body[0]
    if version in (1, 2):
        defined = body[3]
        if version == 2 and not defined:
            return None
        (size,) = struct.unpack_from("<I", body, 4)
        return body[8:8 + size] if size else None
    if version == 3:
        if not body[1] & 0x20:
            return None
        (size,) = struct.unpack_from("<I", body, 2)
        return body[6:6 + size] if size else None
    raise NotImplementedError(f"{name}: fill value message version {version}")


def _filter_pipeline(body: bytes, name: str) -> list:
    """[(filter id, client data)] in the order the writer applied them."""
    version, n = body[0], body[1]
    pos, out = (8 if version == 1 else 2), []
    if version not in (1, 2):
        raise NotImplementedError(f"{name}: filter pipeline message version {version}")
    for _ in range(n):
        (fid,) = struct.unpack_from("<H", body, pos)
        pos += 2
        namelen = 0
        if version == 1 or fid >= 256:
            (namelen,) = struct.unpack_from("<H", body, pos)
            pos += 2
        _flags, nvalues = struct.unpack_from("<HH", body, pos)
        pos += 4
        if version == 1:
            namelen = (namelen + 7) // 8 * 8
        pos += namelen
        values = struct.unpack_from(f"<{nvalues}I", body, pos)
        pos += 4 * nvalues
        if version == 1 and nvalues % 2:
            pos += 4
        if fid not in (1, 2):
            what = _FILTER_NAMES.get(fid, f"id {fid}")
            raise NotImplementedError(f"{name}: the {what} filter (only deflate and "
                                      "shuffle are read)")
        out.append((fid, values))
    return out


def _unfilter(filt, raw: bytes) -> bytes:
    fid, values = filt
    if fid == 1:
        return zlib.decompress(raw)
    size = values[0] if values else 1  # shuffle: the element size
    n = len(raw) // size
    head = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
    return head + raw[n * size:]


def _btree_node(r: _Reader, addr: int, want_type: int, name: str):
    pos = r.base + addr
    if r.buf[pos:pos + 4] != b"TREE":
        raise ValueError(f"{name}: no B-tree node at {addr}")
    ntype, level = r.buf[pos + 4], r.buf[pos + 5]
    if ntype != want_type:
        raise ValueError(f"{name}: B-tree node of type {ntype}, not {want_type}")
    (used,) = struct.unpack_from("<H", r.buf, pos + 6)
    return level, used, pos + 8 + 2 * r.size_o


def _group_entries(r: _Reader, btree: int, heap: int):
    """(name, object header address) of every member of a symbol-table
    group, walking its B-tree to the SNOD leaves."""
    hp = r.base + heap
    if r.buf[hp:hp + 4] != b"HEAP":
        raise ValueError(f"no local heap at {heap}")
    data = r.base + r.uint(hp + 8 + 2 * r.size_l, r.size_o)
    stack = [btree]
    while stack:
        level, used, p = _btree_node(r, stack.pop(), 0, "group")
        children = []
        for i in range(used):
            p += r.size_l  # the key: a name's heap offset
            children.append(r.uint(p, r.size_o))
            p += r.size_o
        if level > 0:
            stack.extend(reversed(children))
            continue
        for snod in children:
            sp = r.base + snod
            if r.buf[sp:sp + 4] != b"SNOD":
                raise ValueError(f"no symbol table node at {snod}")
            (n,) = struct.unpack_from("<H", r.buf, sp + 6)
            e = sp + 8
            for _ in range(n):
                off, header = r.uint(e, r.size_o), r.uint(e + r.size_o, r.size_o)
                end = r.buf.index(b"\0", data + off)
                yield r.buf[data + off:end].decode("utf-8"), header
                e += 2 * r.size_o + 24


def _chunk_btree(r: _Reader, btree: int, ndim: int, name: str):
    """(offset in elements, address, stored size, filter mask) of every
    allocated chunk."""
    key = 8 + 8 * ndim
    stack = [btree]
    while stack:
        level, used, p = _btree_node(r, stack.pop(), 1, name)
        for _ in range(used):
            size, mask = struct.unpack_from("<II", r.buf, p)
            offset = struct.unpack_from(f"<{ndim}Q", r.buf, p + 8)
            child = r.uint(p + key, r.size_o)
            p += key + r.size_o
            if level > 0:
                stack.append(child)
            else:
                yield offset[:-1], child, size, mask
