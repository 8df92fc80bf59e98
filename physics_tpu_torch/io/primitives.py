"""Procedural primitive meshes (host-side NumPy; the subset of
physics_tpu/io/primitives.py the hull scenes use, copied, and the vertex
sets of two families of convex hulls whose largest face has any number
of vertices: prisms and the octahedron)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from physics_tpu_torch.io.meshes import convex_hull


def beveled_cube_mesh(
    size: float = 1.0, bevel: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """Bevel-edged cube spanning ±size with flat faces of half-width
    (size − bevel): 6 square faces + 12 edge bevels + 8 corner triangles
    (26 planes, 24 vertices). Vertices are the permutations (±size,
    ±band, ±band): per corner, 3 vertices each keeping one axis at full
    extent. Returns (verts [24, 3], tris)."""
    s, b = float(size), float(size - bevel)
    pts = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                pts.append([sx * s, sy * b, sz * b])
                pts.append([sx * b, sy * s, sz * b])
                pts.append([sx * b, sy * b, sz * s])
    verts = np.asarray(pts, np.float32)
    _, tris = convex_hull(verts)
    return verts, tris


def prism_verts(sides: int, radius: float = 0.5,
                half_height: float = 0.5) -> np.ndarray:
    """Vertices [2·sides, 3] of a right prism over a regular `sides`-gon
    of circumradius `radius` in the xz plane: two `sides`-vertex caps and
    `sides` quadrilateral walls."""
    ang = 2.0 * np.pi * np.arange(sides) / sides
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    return np.asarray([[x, y, z] for y in (-half_height, half_height)
                       for x, z in ring], np.float32)


def octahedron_verts(s: float = 0.65) -> np.ndarray:
    """The 6 vertices of the regular octahedron of half-diagonal s (8
    triangular faces)."""
    return np.array([[s, 0, 0], [-s, 0, 0], [0, s, 0], [0, -s, 0],
                     [0, 0, s], [0, 0, -s]], np.float32)
