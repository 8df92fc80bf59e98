"""A rain of n bevel-edged cubes as convex hulls (24 vertices, 26 faces)
falling in a column of square layers onto the ground: what the port's
scenes.mesh_rain(n, seed, size, bevel) draws, in the same order, with
its hull library. The hull geometry (the incremental convex hull, its
merged face planes and ordered face polygons, the packed library of
vertices, faces, edge directions and edges) is a frozen copy of the
port's io/meshes.py, io/primitives.beveled_cube_mesh and
scene._pack_hulls, in numpy, run once a scene."""

from __future__ import annotations

import numpy as np

from portbench.core.scene import box_inertia, quat_from_euler


def _face_normal(verts: np.ndarray, tri) -> np.ndarray:
    a, b, c = verts[tri[0]], verts[tri[1]], verts[tri[2]]
    n = np.cross(b - a, c - a)
    norm = np.linalg.norm(n)
    return n / norm if norm > 0 else n


def convex_hull(points: np.ndarray, tol: float = 1e-7) -> np.ndarray:
    """Incremental 3-D convex hull: its faces [F, 3], index triples into
    `points` with outward orientation."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
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
        # horizon: edges of visible faces shared with one visible face
        edge_count = {}
        for fi in visible:
            a, b, c = faces[fi]
            for e in ((a, b), (b, c), (c, a)):
                edge_count.setdefault((min(e), max(e)), []).append(e)
        horizon = [es[0] for es in edge_count.values() if len(es) == 1]
        faces = [f for fi, f in enumerate(faces) if fi not in set(visible)]
        for (a, b) in horizon:
            faces.append((a, b, p))
    return np.asarray(faces, np.int64)


def face_polygons(points: np.ndarray, tol: float = 1e-5):
    """The hull's unique face planes and their boundary polygons:
    (normals [F, 3] f32, offsets [F] f32, F index lists into `points`,
    each counter-clockwise seen from outside)."""
    pts = np.asarray(points, np.float64)
    planes = []
    for f in convex_hull(pts):
        nn = _face_normal(pts, f)
        off = float(np.dot(nn, pts[f[0]]))
        if not any(np.linalg.norm(nn - p[0]) < tol and abs(off - p[1]) < tol
                   for p in planes):
            planes.append((nn, off))
    normals = np.asarray([p[0] for p in planes], np.float32)
    offsets = np.asarray([p[1] for p in planes], np.float32)
    polys = []
    for n, off in zip(normals.astype(np.float64), offsets.astype(np.float64)):
        on_face = np.nonzero(np.abs(pts @ n - off)
                             < 1e-4 * max(1.0, abs(off)))[0]
        center = pts[on_face].mean(axis=0)
        ref = np.array([1.0, 0.0, 0.0])
        if abs(n[0]) > 0.9:
            ref = np.array([0.0, 1.0, 0.0])
        t1 = np.cross(n, ref)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        rel = pts[on_face] - center
        poly = on_face[np.argsort(np.arctan2(rel @ t2, rel @ t1))].tolist()
        p2d = np.stack([(pts[poly] - center) @ t1,
                        (pts[poly] - center) @ t2], axis=1)
        a2 = 0.0
        for i in range(len(poly)):
            j = (i + 1) % len(poly)
            a2 += p2d[i, 0] * p2d[j, 1] - p2d[j, 0] * p2d[i, 1]
        polys.append(poly[::-1] if a2 < 0 else poly)
    return normals, offsets, polys


def beveled_cube(size: float, bevel: float) -> np.ndarray:
    """The bevel-edged cube's 24 vertices [24, 3] f32: per corner the
    permutations (±size, ±band, ±band), band = size − bevel."""
    s, b = float(size), float(size - bevel)
    pts = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                pts.append([sx * s, sy * b, sz * b])
                pts.append([sx * b, sy * s, sz * b])
                pts.append([sx * b, sy * b, sz * s])
    return np.asarray(pts, np.float32)


def hull_library(verts: np.ndarray) -> dict:
    """The one-hull library's packed fields (the port's HullSet): the
    vertices, the face planes and polygons, the unique edge directions
    (up to sign) and the unique undirected edges."""
    normals, offsets, polys = face_polygons(verts)
    v, f = verts.shape[0], normals.shape[0]
    emax = max(len(p) for p in polys)
    fverts = np.zeros((1, f, emax), np.int32)
    fvcount = np.zeros((1, f), np.int32)
    for i, poly in enumerate(polys):
        fverts[0, i, :len(poly)] = poly
        fverts[0, i, len(poly):] = poly[0]
        fvcount[0, i] = len(poly)
    dirs: list = []
    edges: set = set()
    for poly in polys:
        for a, b in zip(poly, list(poly[1:]) + [poly[0]]):
            d = verts[b] - verts[a]
            nrm = np.linalg.norm(d)
            if nrm < 1e-9:
                continue
            edges.add((a, b) if a < b else (b, a))
            d = d / nrm
            if not any(abs(float(d @ e)) > 1.0 - 1e-5 for e in dirs):
                dirs.append(d)
    edirs = np.asarray(dirs, np.float32).reshape(1, -1, 3)
    es = sorted(edges)
    return {
        "verts": verts[None].copy(),
        "vert_count": np.array([v], np.int32),
        "face_normals": normals[None],
        "face_offsets": offsets[None],
        "face_count": np.array([f], np.int32),
        "face_verts": fverts, "face_vert_count": fvcount,
        "edge_dirs": edirs,
        "edge_dir_count": np.array([edirs.shape[1]], np.int32),
        "edge_i0": np.asarray([[a for a, _ in es]], np.int32),
        "edge_i1": np.asarray([[b for _, b in es]], np.int32),
        "edge_count": np.array([len(es)], np.int32),
    }


def make(p: dict, seed: int) -> dict:
    n, size = p["n_bodies"], p["size"]
    rng = np.random.default_rng(seed)
    side = max(1, int(np.ceil(np.sqrt(n / 4))))
    # per body: uniform(-0.2, 0.2, 3) then uniform(-1.5, 1.5, 3)
    u = rng.random((n, 6))
    jitter = -0.2 + 0.4 * u[:, :3]
    euler = -1.5 + 3.0 * u[:, 3:]
    i = np.arange(n)
    layer = i // (side * side)
    gx, gz = (i // side) % side, i % side
    pos = np.stack([
        (gx - side / 2) * 2.5 * size + jitter[:, 0],
        1.5 * size + layer * 3.0 * size + jitter[:, 1],
        (gz - side / 2) * 2.5 * size + jitter[:, 2],
    ], axis=1).astype(np.float32)
    verts = beveled_cube(size, p["bevel"])
    radius = float(np.max(np.linalg.norm(verts, axis=1)))
    f32 = np.float32
    return {
        "pos": pos,
        "quat": quat_from_euler(euler.astype(f32)),
        "mass": np.full((n,), p["mass"], f32),
        "inertia": np.broadcast_to(box_inertia(size, p["mass"]),
                                   (n, 3, 3)).copy(),
        "shapes": {"kind": "hull",
                   "params": np.tile(np.array([radius, 0.0, 0.0], f32),
                                     (n, 1)),
                   "hull_index": np.zeros((n,), np.int32),
                   "friction": np.full((n,), p["friction"], f32),
                   "restitution": np.full((n,), p["restitution"], f32)},
        "hulls": hull_library(verts),
    }
