"""PLY reader/writer.

A copy of `nestinet_tpu/data/ply.py` (numpy only), so that the port imports
nothing of the JAX package; `tests/test_torch_host_library.py` holds the
two equal, file bytes included.

Capability parity with the vendored parser the reference carries
(`utils/plyfile.py:153-916`, used by `utils/pc_util.py:80-98` for
point-cloud IO): ascii / binary_little_endian / binary_big_endian,
arbitrary elements, scalar properties, list properties — including
elements that mix scalar and list properties and elements with several
list properties, as `plyfile.py` supports.  Fast paths: all-scalar
elements parse via one `np.frombuffer`; the common single-list uniform
case (triangle faces) returns an [F, 3] array.

API:
  read_ply(path)         -> {element: structured array | array | dict}
  read_ply_points(path)  -> [N, 3] float32 xyz
  write_ply(path, points, normals=, faces=, binary=)  (pc_util parity)
  write_ply_elements(path, elements, binary=)         (general form)
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
# numpy kind+itemsize -> canonical PLY type name (for writing)
_NP_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def _parse_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # [name, count, [prop]] where prop is
    # ("scalar", name, dtype) or ("list", name, count_dtype, idx_dtype)
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.strip().split()
        if not tokens or tokens[0] in (b"comment", b"obj_info"):
            continue
        if tokens[0] == b"format":
            fmt = tokens[1].decode()
        elif tokens[0] == b"element":
            elements.append([tokens[1].decode(), int(tokens[2]), []])
        elif tokens[0] == b"property":
            if tokens[1] == b"list":
                elements[-1][2].append((
                    "list", tokens[4].decode(),
                    _PLY_DTYPES[tokens[2].decode()],
                    _PLY_DTYPES[tokens[3].decode()],
                ))
            else:
                elements[-1][2].append((
                    "scalar", tokens[2].decode(),
                    _PLY_DTYPES[tokens[1].decode()],
                ))
        elif tokens[0] == b"end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return fmt, elements


def _pack_lists(lists, dtype=np.int64):
    """list-of-lists -> [N, k] array when uniform, else the list.
    `dtype` follows the property's declared element type (float lists
    must stay float — int64 was silently truncating them)."""
    if lists and all(len(x) == len(lists[0]) for x in lists):
        return np.asarray(lists, dtype=dtype)
    return lists


def read_ply(path: str) -> dict:
    """Parse a PLY file -> {element_name: parsed data}.

    All-scalar elements return a structured array (fields =
    properties).  Elements with exactly one (list) property return the
    packed list directly ([F, k] int array when uniform, else a list
    of lists) — the `pc_util.py` faces convention.  Elements mixing
    scalar and list properties (or with several lists) return a dict
    {property: column}, scalar columns as 1-D arrays and list columns
    packed as above.
    """
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(
            fmt, ""
        )
        out = {}
        for name, count, props in elements:
            n_list = sum(1 for p in props if p[0] == "list")
            if n_list == 0:
                dtype = np.dtype([(p[1], endian + p[2]) for p in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.array(
                        [tuple(r) for r in rows],
                        dtype=[(p[1], p[2]) for p in props],
                    )
                else:
                    arr = np.frombuffer(
                        f.read(count * dtype.itemsize), dtype=dtype
                    )
                out[name] = arr
                continue

            # general row-wise parse: scalar and list properties in
            # declaration order (plyfile.py semantics)
            cols = {p[1]: [] for p in props}
            if fmt == "ascii":
                for _ in range(count):
                    vals = f.readline().split()
                    i = 0
                    for p in props:
                        if p[0] == "scalar":
                            cols[p[1]].append(vals[i])
                            i += 1
                        else:
                            k = int(vals[i])
                            cols[p[1]].append(
                                [int(float(v)) if p[3][0] in "iu" else float(v)
                                 for v in vals[i + 1 : i + 1 + k]]
                            )
                            i += 1 + k
            else:
                for _ in range(count):
                    for p in props:
                        if p[0] == "scalar":
                            dt = np.dtype(endian + p[2])
                            cols[p[1]].append(
                                np.frombuffer(f.read(dt.itemsize), dt)[0]
                            )
                        else:
                            cnt_dt = np.dtype(endian + p[2])
                            idx_dt = np.dtype(endian + p[3])
                            k = int(
                                np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0]
                            )
                            cols[p[1]].append(
                                np.frombuffer(
                                    f.read(k * idx_dt.itemsize), idx_dt
                                ).tolist()
                            )

            parsed = {}
            for p in props:
                if p[0] == "scalar":
                    parsed[p[1]] = np.asarray(cols[p[1]], dtype=p[2])
                else:
                    elem_dt = np.float64 if p[3][0] == "f" else np.int64
                    parsed[p[1]] = _pack_lists(cols[p[1]], dtype=elem_dt)
            if n_list == 1 and len(props) == 1:
                out[name] = parsed[props[0][1]]  # faces convention
            else:
                out[name] = parsed
        return out


def read_ply_points(path: str) -> np.ndarray:
    """[N, 3] xyz from a PLY file (parity: `pc_util.py:read_ply`)."""
    vert = read_ply(path)["vertex"]
    return np.stack([vert["x"], vert["y"], vert["z"]], axis=-1).astype(np.float32)


def _ply_type(arr) -> str:
    dt = np.asarray(arr).dtype
    try:
        return _NP_TO_PLY[dt.str[-2:]]
    except KeyError:
        raise ValueError(f"unsupported PLY property dtype: {dt}") from None


def write_ply_elements(path: str, elements: dict, *, binary: bool = True) -> None:
    """Write arbitrary elements: {element: {property: column}}.

    Scalar columns are 1-D arrays; list columns are [N, k] integer
    arrays or lists of per-row sequences (written as
    `property list uchar int`).  Structured arrays are accepted for
    all-scalar elements.  Row counts must agree within an element.
    """
    norm = {}
    for ename, data in elements.items():
        if isinstance(data, np.ndarray) and data.dtype.names:
            data = {fname: data[fname] for fname in data.dtype.names}
        cols = {}
        n_rows = None
        for pname, col in data.items():
            is_list = (
                isinstance(col, (list, tuple))
                or (isinstance(col, np.ndarray) and col.ndim == 2)
            )
            if is_list:
                rows = []
                for r in col:
                    r = np.asarray(r)
                    if r.dtype.kind == "f":
                        raise ValueError(
                            f"{ename}.{pname}: list properties are "
                            "written as int32 indices; got float data "
                            "(pass scalar float columns as 1-D arrays)"
                        )
                    rows.append(r.astype("<i4"))
            else:
                rows = np.asarray(col)
                if rows.ndim != 1:
                    raise ValueError(
                        f"{ename}.{pname}: scalar property must be 1-D"
                    )
            cols[pname] = ("list", rows) if is_list else ("scalar", rows)
            m = len(rows)
            if n_rows is None:
                n_rows = m
            elif n_rows != m:
                raise ValueError(f"{ename}: property row counts differ")
        norm[ename] = (n_rows or 0, cols)

    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0"]
    for ename, (n_rows, cols) in norm.items():
        header.append(f"element {ename} {n_rows}")
        for pname, (kind, rows) in cols.items():
            if kind == "list":
                header.append(f"property list uchar int {pname}")
            else:
                header.append(f"property {_ply_type(rows)} {pname}")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        for ename, (n_rows, cols) in norm.items():
            order = list(cols.items())
            all_scalar = all(kind == "scalar" for _, (kind, _) in order)
            if binary:
                if all_scalar:
                    dtype = np.dtype([
                        (pname, "<" + np.asarray(rows).dtype.str[-2:])
                        for pname, (_, rows) in order
                    ])
                    packed = np.empty(n_rows, dtype=dtype)
                    for pname, (_, rows) in order:
                        packed[pname] = rows
                    f.write(packed.tobytes())
                else:
                    for i in range(n_rows):
                        for pname, (kind, rows) in order:
                            if kind == "scalar":
                                f.write(
                                    np.asarray(rows[i]).astype(
                                        "<" + np.asarray(rows).dtype.str[-2:]
                                    ).tobytes()
                                )
                            else:
                                f.write(np.uint8(len(rows[i])).tobytes())
                                f.write(rows[i].astype("<i4").tobytes())
            else:
                for i in range(n_rows):
                    parts = []
                    for pname, (kind, rows) in order:
                        if kind == "scalar":
                            parts.append(f"{rows[i]:.7g}"
                                         if np.asarray(rows).dtype.kind == "f"
                                         else str(rows[i]))
                        else:
                            parts.append(
                                f"{len(rows[i])} "
                                + " ".join(str(int(v)) for v in rows[i])
                            )
                    f.write((" ".join(parts) + "\n").encode())


def write_ply(
    path: str,
    points: np.ndarray,
    *,
    normals: np.ndarray | None = None,
    faces: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write points (+ optional normals, triangle faces) as PLY
    (parity: `pc_util.py:write_ply`)."""
    points = np.asarray(points, dtype=np.float32)
    vertex = {
        "x": points[:, 0], "y": points[:, 1], "z": points[:, 2],
    }
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        vertex.update(
            nx=normals[:, 0], ny=normals[:, 1], nz=normals[:, 2]
        )
    elements = {"vertex": vertex}
    if faces is not None:
        elements["face"] = {"vertex_indices": faces}
    write_ply_elements(path, elements, binary=binary)
