"""Sphere triangulations via recursive octahedron subdivision.

A copy of ``hyperpocket_tpu/utils/sphere_triangles.py`` (numpy only).

Capability parity with reference ``utils/sphere_triangles.py:1-215`` (dead
code there — never imported, but configs carry ``triangulation_config`` so we
ship a working version). Seven subdivision schemes over the unit octahedron,
every new vertex re-projected onto the sphere:

* ``edge``      — classic 4-way loop subdivision
* ``midpoint``/``midpoint2`` — 2-way split of the p1-p2 edge (midpoint2 keeps
  the reference's intentionally "wrong" winding)
* ``centroid``  — 3-way fan around the normalized centroid
* ``hybrid``/``hybrid2``/``hybrid3`` — alternating compositions of the above

``generate(method, depth) -> ((N, 3) float32 vertices, triangle index array)``
— vertices are emitted per-face (3 per triangle, duplicated across faces)
exactly like the reference, so downstream triangulations index ``3i, 3i+1,
3i+2``. We return the raw index array instead of a matplotlib Triangulation;
``to_matplotlib_triangulation`` converts when plotting is wanted.
"""

from __future__ import annotations

import math
from typing import Iterator, NamedTuple

import numpy as np


class Point(NamedTuple):
    x: float
    y: float
    z: float


class Triangle(NamedTuple):
    a: Point
    b: Point
    c: Point


def _normalize(p: Point) -> Point:
    s = math.sqrt(p.x * p.x + p.y * p.y + p.z * p.z)
    return Point(p.x / s, p.y / s, p.z / s)


def _midpoint(u: Point, v: Point) -> Point:
    return Point((u.x + v.x) / 2, (u.y + v.y) / 2, (u.z + v.z) / 2)


def subdivide_edge(tri: Triangle, depth: int) -> Iterator[Triangle]:
    if depth == 0:
        yield tri
        return
    p0, p1, p2 = tri
    m01, m02, m12 = _normalize(_midpoint(p0, p1)), _normalize(_midpoint(p0, p2)), _normalize(_midpoint(p1, p2))
    for t in (Triangle(p0, m01, m02), Triangle(m01, p1, m12),
              Triangle(m02, m12, p2), Triangle(m01, m02, m12)):
        yield from subdivide_edge(t, depth - 1)


def subdivide_midpoint(tri: Triangle, depth: int) -> Iterator[Triangle]:
    if depth == 0:
        yield tri
        return
    p0, p1, p2 = tri
    m12 = _normalize(_midpoint(p1, p2))
    yield from subdivide_midpoint(Triangle(m12, p0, p1), depth - 1)
    yield from subdivide_midpoint(Triangle(m12, p2, p0), depth - 1)


def subdivide_midpoint2(tri: Triangle, depth: int) -> Iterator[Triangle]:
    if depth == 0:
        yield tri
        return
    p0, p1, p2 = tri
    m12 = _normalize(_midpoint(p1, p2))
    # keeps the reference's flipped winding (sphere_triangles.py:94-96)
    yield from subdivide_midpoint2(Triangle(p0, m12, p1), depth - 1)
    yield from subdivide_midpoint2(Triangle(p0, p2, m12), depth - 1)


def subdivide_centroid(tri: Triangle, depth: int) -> Iterator[Triangle]:
    if depth == 0:
        yield tri
        return
    p0, p1, p2 = tri
    c = _normalize(Point((p0.x + p1.x + p2.x) / 3, (p0.y + p1.y + p2.y) / 3,
                         (p0.z + p1.z + p2.z) / 3))
    yield from subdivide_centroid(Triangle(p0, p1, c), depth - 1)
    yield from subdivide_centroid(Triangle(p2, c, p0), depth - 1)
    yield from subdivide_centroid(Triangle(c, p1, p2), depth - 1)


def subdivide_hybrid(tri: Triangle, depth: int) -> Iterator[Triangle]:
    def centroid(t, d):
        if d == 0:
            yield t
            return
        for s in subdivide_centroid(t, 1):
            yield from edge(s, d - 1)

    def edge(t, d):
        if d == 0:
            yield t
            return
        for s in subdivide_edge(t, 1):
            yield from centroid(s, d - 1)

    return edge(tri, depth)


def subdivide_hybrid2(tri: Triangle, depth: int) -> Iterator[Triangle]:
    def centroid(t, d):
        if d == 0:
            yield t
            return
        for s in subdivide_centroid(t, 1):
            yield from edge(s, d - 1)

    def edge(t, d):
        if d == 0:
            yield t
            return
        for s in subdivide_edge(t, 1):
            yield from centroid(s, d - 1)

    return centroid(tri, depth)


def subdivide_hybrid3(tri: Triangle, depth: int) -> Iterator[Triangle]:
    def triangle(t, d):
        if d == 0:
            yield t
            return
        for s in subdivide_centroid(t, 1):
            yield from edge(s, d - 1)

    def centroid(t, d):
        if d == 0:
            yield t
            return
        for s in subdivide_midpoint(t, 2):
            yield from triangle(s, d - 1)

    def edge(t, d):
        if d == 0:
            yield t
            return
        for s in subdivide_edge(t, 1):
            yield from centroid(s, d - 1)

    return centroid(tri, depth)


METHODS = {
    "hybrid": subdivide_hybrid,
    "hybrid2": subdivide_hybrid2,
    "hybrid3": subdivide_hybrid3,
    "midpoint": subdivide_midpoint,
    "midpoint2": subdivide_midpoint2,
    "centroid": subdivide_centroid,
    "edge": subdivide_edge,
}


def octahedron_faces() -> list[Triangle]:
    p = math.sqrt(2) / 2
    top, bottom = Point(0, 1, 0), Point(0, -1, 0)
    ring = [Point(-p, 0, p), Point(p, 0, p), Point(p, 0, -p), Point(-p, 0, -p)]
    faces = [Triangle(top, ring[i], ring[(i + 1) % 4]) for i in range(4)]
    faces += [Triangle(bottom, ring[(i + 1) % 4], ring[i]) for i in range(4)]
    return faces


def generate(method: str, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (3*F, 3) float32, triangle indices (F, 3) int32)."""
    subdivider = METHODS[method]
    verts: list[tuple[float, float, float]] = []
    tris: list[list[int]] = []
    for i, tri in enumerate(t for face in octahedron_faces() for t in subdivider(face, int(depth))):
        verts.extend((p.x, p.y, p.z) for p in tri)
        tris.append([3 * i, 3 * i + 1, 3 * i + 2])
    return np.asarray(verts, dtype=np.float32), np.asarray(tris, dtype=np.int32)


def to_matplotlib_triangulation(points: np.ndarray, triangles: np.ndarray):
    import matplotlib.tri as mtri

    return mtri.Triangulation(points[:, 0], points[:, 1], triangles)
