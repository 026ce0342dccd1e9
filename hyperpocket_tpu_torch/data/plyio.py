"""PLY I/O: point clouds, and whole files of elements.

Port of ``hyperpocket_tpu/data/plyio.py``'s numpy code, kept inside this
package so that the port runs without importing the JAX package:

* ``load_ply`` reads the vertex x/y/z as (N, 3) float32 from ascii,
  binary_little_endian or binary_big_endian files, skipping the payload of
  any list property on the vertex element or on the elements before it;
  like the JAX package's, it tries the native reader (``data/native.py``)
  first and takes the numpy parser where that does not load or parse;
* ``save_ply`` writes binary little-endian float x/y/z, byte for byte the
  JAX package's layout;
* ``save_ply_elements`` / ``load_ply_elements`` write and read any
  elements with scalar properties of every PLY type and list properties
  (``ListProperty``), in the three formats, with comments: the same bytes
  and the same arrays as the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

_PLY_TO_NUMPY = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


class PlyParseError(ValueError):
    pass


def _parse_header(f) -> tuple[str, list[tuple[str, int, list[tuple[str, str]]]]]:
    if f.readline().strip() != b"ply":
        raise PlyParseError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    while True:
        line = f.readline()
        if not line:
            raise PlyParseError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").split()
        if not tokens or tokens[0] in ("comment", "obj_info"):
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if not elements:
                raise PlyParseError("property before element")
            # a list is ("list", count type, value type); a scalar its type name
            ptype = ("list", tokens[2], tokens[3]) if tokens[1] == "list" else tokens[1]
            elements[-1][2].append((tokens[-1], ptype))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise PlyParseError("PLY header missing format line")
    return fmt, elements


def load_ply(path: str | os.PathLike) -> np.ndarray:
    """Read the vertex x/y/z columns of a PLY file -> (N, 3) float32.

    The native C++ reader (``data/native.py``) when it loads (binary
    little-endian files), the numpy parser for everything else, as in the
    JAX package.
    """
    from hyperpocket_tpu_torch.data import native

    if native.available():
        try:
            return native.load_ply(path)
        except Exception:
            pass  # ascii/odd files: numpy path below
    return _load_ply_numpy(path)


def reader() -> str:
    """Which reader ``load_ply`` tries first: ``"native"`` or ``"numpy"``."""
    from hyperpocket_tpu_torch.data import native

    return "native" if native.available() else "numpy"


def _load_ply_numpy(path: str | os.PathLike) -> np.ndarray:
    """The numpy PLY reader: x/y/z of the vertex element -> (N, 3) float32."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        names = [e[0] for e in elements]
        if "vertex" not in names:
            raise PlyParseError(f"{path}: no vertex element")
        vi = names.index("vertex")
        _, count, vprops = elements[vi]
        pnames = [n for n, _ in vprops]
        for axis in ("x", "y", "z"):
            if axis not in pnames:
                raise PlyParseError(f"{path}: vertex missing property {axis!r}")
        if fmt == "ascii":
            # one line a row whatever its lists: skip the earlier elements' lines
            skip = sum(e[1] for e in elements[:vi])
            lines = f.read().decode("ascii").splitlines()[skip:skip + count]
            if len(lines) != count or not all(line.split() for line in lines):
                raise PlyParseError(f"{path}: truncated vertex data")
            return np.array([_ascii_xyz(line.split(), vprops) for line in lines],
                            dtype=np.float32).reshape(count, 3)
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        if endian is None:
            raise PlyParseError(f"{path}: unsupported PLY format {fmt!r}")
        buf = f.read()
        pos = 0
        for name, n_rows, props in elements[:vi]:
            pos = _skip_binary_rows(path, buf, pos, name, n_rows, props, endian)
        if all(not isinstance(t, tuple) for _, t in vprops):
            dtype = np.dtype([(n, endian + _PLY_TO_NUMPY[t]) for n, t in vprops])
            if pos + dtype.itemsize * count > len(buf):
                raise PlyParseError(f"{path}: truncated vertex data")
            raw = np.frombuffer(buf, dtype=dtype, count=count, offset=pos)
            return np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float32)
        out = np.empty((count, 3), dtype=np.float32)
        for r in range(count):
            row = {}
            for pname, ptype in vprops:
                if isinstance(ptype, tuple):
                    pos = _skip_list(path, buf, pos, ptype, endian)
                else:
                    if pname in ("x", "y", "z"):
                        row[pname] = _scalar(path, buf, pos, ptype, endian)
                    pos += np.dtype(_PLY_TO_NUMPY[ptype]).itemsize
            if pos > len(buf):
                raise PlyParseError(f"{path}: truncated vertex data")
            out[r] = (row["x"], row["y"], row["z"])
        return out


def _ascii_xyz(tokens: list[str], props) -> tuple[float, float, float]:
    """x, y, z of one ascii vertex row; a list's payload is its count, then the values."""
    row, i = {}, 0
    for pname, ptype in props:
        if isinstance(ptype, tuple):
            i += 1 + int(tokens[i])
        else:
            if pname in ("x", "y", "z"):
                row[pname] = float(tokens[i])
            i += 1
    return row["x"], row["y"], row["z"]


def _scalar(path, buf: bytes, at: int, ptype: str, endian: str):
    dtype = np.dtype(endian + _PLY_TO_NUMPY[ptype])
    if at + dtype.itemsize > len(buf):
        raise PlyParseError(f"{path}: truncated element data")
    return np.frombuffer(buf, dtype, count=1, offset=at)[0]


def _skip_list(path, buf: bytes, pos: int, ptype, endian: str) -> int:
    """The offset past one binary list: its count, then that many values."""
    _, count_type, value_type = ptype
    n = int(_scalar(path, buf, pos, count_type, endian))
    return (pos + np.dtype(_PLY_TO_NUMPY[count_type]).itemsize
            + n * np.dtype(_PLY_TO_NUMPY[value_type]).itemsize)


def _skip_binary_rows(path, buf: bytes, pos: int, name: str, n_rows: int, props,
                      endian: str) -> int:
    """The offset past ``n_rows`` binary rows of an element before the vertex."""
    if all(not isinstance(t, tuple) for _, t in props):
        pos += n_rows * sum(np.dtype(_PLY_TO_NUMPY[t]).itemsize for _, t in props)
    else:
        for _ in range(n_rows):
            for _, ptype in props:
                pos = (_skip_list(path, buf, pos, ptype, endian) if isinstance(ptype, tuple)
                       else pos + np.dtype(_PLY_TO_NUMPY[ptype]).itemsize)
    if pos > len(buf):
        raise PlyParseError(f"{path}: truncated element {name!r}")
    return pos


def save_ply(path: str | os.PathLike, points: np.ndarray) -> None:
    """Write (N, 3) points as binary little-endian PLY (x, y, z float32)."""
    points = np.ascontiguousarray(points, dtype="<f4")
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"expected (N, 3) points, got {points.shape}")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {points.shape[0]}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(points.tobytes())


# ---------------------------------------------------------------------------
# Elements: any element, scalar and list properties

_NUMPY_TO_PLY = {
    "f4": "float", "f8": "double", "i1": "char", "u1": "uchar",
    "i2": "short", "u2": "ushort", "i4": "int", "u4": "uint",
}


class ListProperty:
    """A PLY list property: one 1-D array a row.

    ``count_type`` and ``value_type`` are PLY type names ("uchar", "int", ...).
    A row longer than ``count_type`` can count is refused here, before any
    byte is written.
    """

    def __init__(self, rows, count_type: str = "uchar", value_type: str = "int"):
        if count_type not in _PLY_TO_NUMPY or value_type not in _PLY_TO_NUMPY:
            raise ValueError(f"unknown PLY type {count_type!r}/{value_type!r}")
        self.rows = [np.asarray(r, dtype=_PLY_TO_NUMPY[value_type]) for r in rows]
        count_max = np.iinfo(_PLY_TO_NUMPY[count_type]).max
        for i, r in enumerate(self.rows):
            if len(r) > count_max:
                raise ValueError(f"list row {i} has {len(r)} elements, which overflows "
                                 f"count_type {count_type!r} (max {count_max})")
        self.count_type = count_type
        self.value_type = value_type

    def __len__(self):
        return len(self.rows)

    def __eq__(self, other):
        return (isinstance(other, ListProperty)
                and self.count_type == other.count_type
                and self.value_type == other.value_type
                and len(self.rows) == len(other.rows)
                and all(np.array_equal(a, b) for a, b in zip(self.rows, other.rows)))


def _ply_type_name(arr: np.ndarray) -> str:
    code = arr.dtype.str.lstrip("<>|=")
    if code not in _NUMPY_TO_PLY:
        raise ValueError(f"dtype {arr.dtype} has no PLY scalar type")
    return _NUMPY_TO_PLY[code]


def _ascii_scalar(v) -> str:
    """Integers exactly; floats by ``repr``, which reads back to the same value."""
    if np.issubdtype(np.asarray(v).dtype, np.integer):
        return str(int(v))
    return repr(float(v))


def save_ply_elements(path, elements, fmt: str = "binary_little_endian",
                      comments=()) -> None:
    """Write ``elements``: a sequence of ``(name, props)``, ``props`` a sequence
    of ``(prop_name, data)`` with data a 1-D array (its dtype gives the PLY
    type) or a ``ListProperty``. The properties of an element have one
    length. ``fmt``: ascii, binary_little_endian or binary_big_endian."""
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")
    endian = ">" if fmt == "binary_big_endian" else "<"
    lines = ["ply", f"format {fmt} 1.0"]
    lines += [f"comment {c}" for c in comments]
    norm = []
    for name, props in elements:
        counts = {len(d) for _, d in props}
        if len(counts) != 1:
            raise ValueError(f"element {name!r}: property lengths differ: {counts}")
        (count,) = counts
        lines.append(f"element {name} {count}")
        nprops = []
        for pname, data in props:
            if isinstance(data, ListProperty):
                lines.append(f"property list {data.count_type} {data.value_type} {pname}")
            else:
                data = np.asarray(data)
                if data.ndim != 1:
                    raise ValueError(f"scalar property {name}.{pname} must be 1-D")
                lines.append(f"property {_ply_type_name(data)} {pname}")
            nprops.append((pname, data))
        norm.append((count, nprops))
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        for count, nprops in norm:
            if fmt == "ascii":
                for r in range(count):
                    toks = []
                    for _, data in nprops:
                        if isinstance(data, ListProperty):
                            toks.append(str(len(data.rows[r])))
                            toks += [_ascii_scalar(v) for v in data.rows[r]]
                        else:
                            toks.append(_ascii_scalar(data[r]))
                    f.write((" ".join(toks) + "\n").encode("ascii"))
            elif not any(isinstance(d, ListProperty) for _, d in nprops):
                rec = np.empty(count, dtype=np.dtype(
                    [(p, endian + d.dtype.str.lstrip("<>|=")) for p, d in nprops]))
                for pname, data in nprops:
                    rec[pname] = data
                f.write(rec.tobytes())
            else:
                for r in range(count):
                    for _, data in nprops:
                        if isinstance(data, ListProperty):
                            row = data.rows[r]
                            f.write(np.asarray(len(row), dtype=endian
                                               + _PLY_TO_NUMPY[data.count_type]).tobytes())
                            f.write(row.astype(endian + _PLY_TO_NUMPY[data.value_type]).tobytes())
                        else:
                            f.write(np.asarray(data[r], dtype=endian
                                               + data.dtype.str.lstrip("<>|=")).tobytes())


def load_ply_elements(path):
    """Read a whole PLY file: ``[(element, [(prop, data), ...]), ...]``, the
    structure ``save_ply_elements`` takes, scalars as native-endian 1-D
    arrays and lists as ``ListProperty``."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        if fmt == "ascii":
            return _load_elements_ascii(path, f, elements)
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        if endian is None:
            raise PlyParseError(f"{path}: unsupported PLY format {fmt!r}")
        return _load_elements_binary(path, f.read(), elements, endian)


def _columns(cols: dict, props) -> list:
    return [(p, ListProperty(cols[p], t[1], t[2]) if isinstance(t, tuple)
             else np.asarray(cols[p], dtype=_PLY_TO_NUMPY[t])) for p, t in props]


def _load_elements_binary(path, buf: bytes, elements, endian: str):
    pos, result = 0, []
    for name, n_rows, props in elements:
        if all(not isinstance(t, tuple) for _, t in props):
            dtype = np.dtype([(p, endian + _PLY_TO_NUMPY[t]) for p, t in props])
            end = pos + dtype.itemsize * n_rows
            if end > len(buf):
                raise PlyParseError(f"{path}: truncated element {name!r}")
            rec = np.frombuffer(buf, dtype=dtype, count=n_rows, offset=pos)
            result.append((name, [(p, np.ascontiguousarray(rec[p]).astype(
                rec[p].dtype.newbyteorder("="))) for p, _ in props]))
            pos = end
            continue
        cols: dict[str, list] = {p: [] for p, _ in props}
        for _ in range(n_rows):
            for p, t in props:
                if isinstance(t, tuple):
                    _, ct, vt = t
                    k = int(_scalar(path, buf, pos, ct, endian))
                    pos += np.dtype(_PLY_TO_NUMPY[ct]).itemsize
                    size = k * np.dtype(_PLY_TO_NUMPY[vt]).itemsize
                    if pos + size > len(buf):
                        raise PlyParseError(f"{path}: truncated element {name!r}")
                    cols[p].append(np.frombuffer(buf, endian + _PLY_TO_NUMPY[vt], count=k,
                                                 offset=pos).astype(_PLY_TO_NUMPY[vt]))
                    pos += size
                else:
                    cols[p].append(_scalar(path, buf, pos, t, endian))
                    pos += np.dtype(_PLY_TO_NUMPY[t]).itemsize
        result.append((name, _columns(cols, props)))
    return result


def _load_elements_ascii(path, f, elements):
    result = []
    for name, n_rows, props in elements:
        cols: dict[str, list] = {p: [] for p, _ in props}
        for _ in range(n_rows):
            tokens = f.readline().split()
            if not tokens and props:
                raise PlyParseError(f"{path}: truncated element {name!r}")
            i = 0
            for p, t in props:
                if isinstance(t, tuple):
                    k = int(tokens[i])
                    cols[p].append(np.array(tokens[i + 1:i + 1 + k], dtype=_PLY_TO_NUMPY[t[2]]))
                    i += 1 + k
                else:
                    cols[p].append(np.dtype(_PLY_TO_NUMPY[t]).type(float(tokens[i]))
                                   if t in ("float", "float32", "double", "float64")
                                   else int(tokens[i]))
                    i += 1
        result.append((name, _columns(cols, props)))
    return result
