"""PLY point-cloud I/O for the serving CLI.

The (N, 3) x/y/z subset of ``hyperpocket_tpu/data/plyio.py``, kept inside
this package so that the port runs without importing the JAX package:
``load_ply`` reads the vertex x/y/z from ascii, binary_little_endian or
binary_big_endian files, skipping the payload of any list property on the
vertex element or on the elements before it.
``save_ply`` writes binary little-endian float x/y/z, byte for byte the
JAX package's layout.
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
    """Read the vertex x/y/z columns of a PLY file -> (N, 3) float32."""
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
