"""PLY point-cloud I/O for the serving CLI.

The (N, 3) x/y/z subset of ``hyperpocket_tpu/data/plyio.py``, kept inside
this package so that the port runs without importing the JAX package:
``load_ply`` reads the vertex x/y/z from ascii, binary_little_endian or
binary_big_endian files. The vertex element must have scalar properties
only, and in binary files so must the elements before it; anything else
raises ``PlyParseError``.
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
            ptype = "list" if tokens[1] == "list" else tokens[1]
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
        before = elements[:vi] if fmt != "ascii" else []  # ascii skips whole lines
        if any(t == "list" for _, _, props in before + [elements[vi]] for _, t in props):
            raise PlyParseError(f"{path}: list properties in or (binary) before the vertex "
                                "element are not supported")
        if fmt == "ascii":
            skip = sum(e[1] for e in elements[:vi])
            lines = f.read().decode("ascii").splitlines()[skip:skip + count]
            if len(lines) != count:
                raise PlyParseError(f"{path}: truncated vertex data")
            cols = [pnames.index(a) for a in ("x", "y", "z")]
            return np.array([[float(line.split()[c]) for c in cols] for line in lines],
                            dtype=np.float32).reshape(count, 3)
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        if endian is None:
            raise PlyParseError(f"{path}: unsupported PLY format {fmt!r}")
        dtypes = [(n_rows, np.dtype([(n, endian + _PLY_TO_NUMPY[t]) for n, t in props]))
                  for _, n_rows, props in elements[: vi + 1]]
        f.seek(sum(n * dt.itemsize for n, dt in dtypes[:-1]), os.SEEK_CUR)
        raw = np.fromfile(f, dtype=dtypes[-1][1], count=count)
        if raw.shape[0] != count:
            raise PlyParseError(f"{path}: truncated vertex data")
        return np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float32)


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
