"""Host-side mesh geometry: convex hulls and inertia tensors (the subset
of physics_tpu/io/meshes.py the box and hull scenes use, copied: NumPy
only, run once at scene-build time)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _face_normal(verts: np.ndarray, tri) -> np.ndarray:
    a, b, c = verts[tri[0]], verts[tri[1]], verts[tri[2]]
    n = np.cross(b - a, c - a)
    norm = np.linalg.norm(n)
    return n / norm if norm > 0 else n


def convex_hull(points: np.ndarray, tol: float = 1e-7):
    """Incremental 3-D convex hull. Returns (vertex_indices, faces [F,3]):
    index triples into `points` with outward orientation."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n < 4:
        raise ValueError("need at least 4 points for a 3D hull")

    # initial simplex: extreme points
    i0 = int(np.argmin(pts[:, 0]))
    i1 = int(np.argmax(np.linalg.norm(pts - pts[i0], axis=1)))
    d01 = pts[i1] - pts[i0]
    cr = np.cross(d01, pts - pts[i0])
    i2 = int(np.argmax(np.linalg.norm(cr, axis=1)))
    nrm = np.cross(d01, pts[i2] - pts[i0])
    i3 = int(np.argmax(np.abs(np.dot(pts - pts[i0], nrm))))
    if abs(np.dot(pts[i3] - pts[i0], nrm)) < tol:
        raise ValueError("degenerate (coplanar) point set")

    faces = [(i0, i1, i2), (i0, i2, i3), (i0, i3, i1), (i1, i3, i2)]
    centroid = pts[[i0, i1, i2, i3]].mean(axis=0)

    def orient(tri):
        nn = _face_normal(pts, tri)
        if np.dot(nn, pts[tri[0]] - centroid) < 0:
            return (tri[0], tri[2], tri[1])
        return tri

    faces = [orient(f) for f in faces]

    for p in range(n):
        if p in (i0, i1, i2, i3):
            continue
        visible = []
        for fi, f in enumerate(faces):
            nn = _face_normal(pts, f)
            if np.dot(nn, pts[p] - pts[f[0]]) > tol:
                visible.append(fi)
        if not visible:
            continue
        # horizon = edges of visible faces shared with exactly one visible face
        edge_count = {}
        for fi in visible:
            a, b, c = faces[fi]
            for e in ((a, b), (b, c), (c, a)):
                key = (min(e), max(e))
                edge_count.setdefault(key, []).append(e)
        horizon = [es[0] for es in edge_count.values() if len(es) == 1]
        faces = [f for fi, f in enumerate(faces) if fi not in set(visible)]
        for (a, b) in horizon:
            faces.append((a, b, p))

    used = sorted({i for f in faces for i in f})
    return np.asarray(used, np.int64), np.asarray(faces, np.int64)


def convex_hull_faces(points: np.ndarray, merge_tol: float = 1e-5
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Unique outward face planes (normals [F,3], offsets [F]) of the hull of
    `points`, with coplanar triangles merged. Inside test: n·x ≤ offset."""
    pts = np.asarray(points, np.float64)
    _, faces = convex_hull(pts)
    planes = []
    for f in faces:
        nn = _face_normal(pts, f)
        off = float(np.dot(nn, pts[f[0]]))
        dup = any(
            np.linalg.norm(nn - p[0]) < merge_tol and abs(off - p[1]) < merge_tol
            for p in planes
        )
        if not dup:
            planes.append((nn, off))
    normals = np.asarray([p[0] for p in planes], np.float32)
    offsets = np.asarray([p[1] for p in planes], np.float32)
    return normals, offsets


def convex_hull_face_polygons(points: np.ndarray, tol: float = 1e-5):
    """Unique hull face planes plus their ordered boundary polygons:
    (normals [F,3], offsets [F], polys: F index lists into `points`, each
    counter-clockwise seen from outside) — the HullSet face_verts the
    reference-face clip reads."""
    pts = np.asarray(points, np.float64)
    normals, offsets = convex_hull_faces(pts, merge_tol=tol)
    polys = []
    for n, off in zip(normals.astype(np.float64), offsets.astype(np.float64)):
        on_face = np.nonzero(np.abs(pts @ n - off) < 1e-4 * max(1.0, abs(off)))[0]
        center = pts[on_face].mean(axis=0)
        # 2D basis in the face plane
        ref = np.array([1.0, 0.0, 0.0])
        if abs(n[0]) > 0.9:
            ref = np.array([0.0, 1.0, 0.0])
        t1 = np.cross(n, ref)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        rel = pts[on_face] - center
        ang = np.arctan2(rel @ t2, rel @ t1)
        order = on_face[np.argsort(ang)]
        # ensure CCW when viewed from outside (along -n): the signed area
        # in the (t1, t2) basis must be positive with (t1, t2, n) RH
        poly = order.tolist()
        a2 = 0.0
        p2d = np.stack([(pts[poly] - center) @ t1, (pts[poly] - center) @ t2],
                       axis=1)
        for i in range(len(poly)):
            j = (i + 1) % len(poly)
            a2 += p2d[i, 0] * p2d[j, 1] - p2d[j, 0] * p2d[i, 1]
        if a2 < 0:
            poly = poly[::-1]
        polys.append(poly)
    return normals, offsets, polys


def box_inertia(half_extents, mass: float) -> np.ndarray:
    """Solid-box inertia tensor about its COM."""
    hx, hy, hz = [float(h) for h in half_extents]
    m = float(mass)
    return np.diag([
        m / 3.0 * (hy * hy + hz * hz),
        m / 3.0 * (hx * hx + hz * hz),
        m / 3.0 * (hx * hx + hy * hy),
    ]).astype(np.float32)


def sphere_inertia(radius: float, mass: float) -> np.ndarray:
    """Solid-sphere inertia tensor about its COM."""
    i = 2.0 / 5.0 * float(mass) * float(radius) ** 2
    return (np.eye(3) * i).astype(np.float32)
