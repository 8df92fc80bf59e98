"""Procedural primitive meshes (host-side NumPy; the subset of
physics_tpu/io/primitives.py the hull scenes use, copied)."""

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
