"""Host-side scene construction (the SceneBuilder subset the box and hull
scenes use: bodies, boxes and convex hulls; no joints or spheres).

Bodies accumulate in numpy lists; `build` assembles the state arrays and
sends them to the device in one copy (state.state_from_arrays).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from physics_tpu_torch.state import SHAPE_BOX, SHAPE_HULL, SHAPE_NONE, SimState
from physics_tpu_torch.state import make_arrays, state_from_arrays


def _from_euler_np(roll, pitch, yaw) -> np.ndarray:
    """Quaternion (w, x, y, z) from roll-pitch-yaw, R = Rz·Ry·Rx (the
    JAX package's scene._from_euler_np)."""
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    sr, cr = np.sin(hr), np.cos(hr)
    sp, cp = np.sin(hp), np.cos(hp)
    sy, cy = np.sin(hy), np.cos(hy)
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        np.float32,
    )


class SceneBuilder:
    """Accumulates bodies, box shapes and convex hulls on the host, then
    `build()`s a SimState on a device."""

    def __init__(self):
        self._pos, self._quat, self._vel, self._omega = [], [], [], []
        self._mass, self._inertia = [], []
        self._stype, self._sparams, self._hull_index = [], [], []
        self._friction, self._restitution = [], []
        self._hulls: list = []   # (verts [V,3], normals [F,3], offsets [F], polys)

    def add_body(self, pos=(0.0, 0.0, 0.0), quat=None, euler=None,
                 vel=(0.0, 0.0, 0.0), omega=(0.0, 0.0, 0.0),
                 mass: float = 1.0, inertia=None,
                 static: bool = False) -> int:
        """Add a rigid body (mass 1, identity inertia and orientation by
        default); returns its index."""
        if quat is not None and euler is not None:
            raise ValueError("give either quat or euler, not both")
        if euler is not None:
            q = _from_euler_np(*np.asarray(euler, np.float32))
        elif quat is not None:
            q = np.asarray(quat, np.float32)
        else:
            q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        if static:
            mass = np.inf
            inertia = np.full((3, 3), np.inf, np.float32)
        if inertia is None:
            inertia = np.eye(3, dtype=np.float32)
        self._pos.append(np.asarray(pos, np.float32))
        self._quat.append(q)
        self._vel.append(np.asarray(vel, np.float32))
        self._omega.append(np.asarray(omega, np.float32))
        self._mass.append(np.float32(mass))
        self._inertia.append(np.asarray(inertia, np.float32))
        self._stype.append(SHAPE_NONE)
        self._sparams.append(np.zeros(3, np.float32))
        self._hull_index.append(-1)
        self._friction.append(0.5)
        self._restitution.append(0.0)
        return len(self._pos) - 1

    def set_box(self, body: int, half_extents, friction=0.5,
                restitution=0.0):
        self._stype[body] = SHAPE_BOX
        self._sparams[body] = np.asarray(half_extents, np.float32)
        self._friction[body] = friction
        self._restitution[body] = restitution

    def add_hull(self, verts) -> int:
        """Register a convex hull (body-frame vertices); returns hull id."""
        from physics_tpu_torch.io.meshes import convex_hull_face_polygons

        verts = np.asarray(verts, np.float32)
        normals, offsets, polys = convex_hull_face_polygons(verts)
        self._hulls.append((verts, normals, offsets, polys))
        return len(self._hulls) - 1

    def set_hull(self, body: int, hull_id: int, friction=0.5,
                 restitution=0.0):
        verts = self._hulls[hull_id][0]
        # bounding radius stored for the broad phase
        r = float(np.max(np.linalg.norm(verts, axis=1)))
        self._stype[body] = SHAPE_HULL
        self._sparams[body] = np.array([r, 0, 0], np.float32)
        self._hull_index[body] = hull_id
        self._friction[body] = friction
        self._restitution[body] = restitution

    def build(self, device: torch.device | str = "cuda") -> SimState:
        """The SimState on `device` (the card unless the caller asks for
        the CPU; state.resolve_device)."""
        n = len(self._pos)
        if n == 0:
            raise ValueError("scene has no bodies")
        stypes = np.asarray(self._stype, np.int32)
        if self._hulls and np.any(stypes == SHAPE_BOX):
            raise NotImplementedError(
                "scenes with both boxes and hulls (the JAX package converts "
                "the boxes to hulls, mixed_as_hulls) are ROADMAP item 1.13")
        shapes = {
            "stype": stypes,
            "params": np.stack(self._sparams),
            "hull_index": np.asarray(self._hull_index, np.int32),
            "friction": np.asarray(self._friction, np.float32),
            "restitution": np.asarray(self._restitution, np.float32),
        }
        arrays = make_arrays(
            np.stack(self._pos), np.stack(self._quat), np.stack(self._vel),
            np.stack(self._omega), np.asarray(self._mass),
            np.stack(self._inertia), shapes,
            _pack_hulls(self._hulls) if self._hulls else None)
        return state_from_arrays(arrays, device)


def _pack_hulls(hulls: Sequence) -> Dict[str, np.ndarray]:
    """The HullSet fields of a hull library, padded to shared capacities
    (physics_tpu/scene.py _pack_hulls): vertices padded with vertex 0,
    faces with far-away planes, polygons by repeating their first
    vertex; unique edge directions (up to sign) and unique undirected
    edges per hull."""
    vmax = max(h[0].shape[0] for h in hulls)
    fmax = max(h[1].shape[0] for h in hulls)
    emax = max((len(p) for h in hulls for p in h[3]), default=1)
    hcount = len(hulls)
    verts = np.zeros((hcount, vmax, 3), np.float32)
    vcount = np.zeros(hcount, np.int32)
    normals = np.zeros((hcount, fmax, 3), np.float32)
    offsets = np.zeros((hcount, fmax), np.float32)
    fcount = np.zeros(hcount, np.int32)
    fverts = np.zeros((hcount, fmax, emax), np.int32)
    fvcount = np.zeros((hcount, fmax), np.int32)
    for i, (v, fn, fo, polys) in enumerate(hulls):
        verts[i, : v.shape[0]] = v
        verts[i, v.shape[0]:] = v[0]
        vcount[i] = v.shape[0]
        normals[i, : fn.shape[0]] = fn
        offsets[i, : fo.shape[0]] = fo
        offsets[i, fo.shape[0]:] = 1e30
        fcount[i] = fn.shape[0]
        for f, poly in enumerate(polys):
            fverts[i, f, : len(poly)] = poly
            fverts[i, f, len(poly):] = poly[0]
            fvcount[i, f] = len(poly)

    dir_lists = []
    edge_lists = []
    for v, fn, fo, polys in hulls:
        dirs: list = []
        edges: set = set()
        for poly in polys:
            for a, b in zip(poly, list(poly[1:]) + [poly[0]]):
                d = v[b] - v[a]
                nrm = np.linalg.norm(d)
                if nrm < 1e-9:
                    continue
                edges.add((a, b) if a < b else (b, a))
                d = d / nrm
                if not any(abs(float(d @ e)) > 1.0 - 1e-5 for e in dirs):
                    dirs.append(d)
        dir_lists.append(np.asarray(dirs, np.float32).reshape(-1, 3))
        edge_lists.append(sorted(edges))
    dmax = max((d.shape[0] for d in dir_lists), default=1) or 1
    edirs = np.zeros((hcount, dmax, 3), np.float32)
    edcount = np.zeros(hcount, np.int32)
    for i, d in enumerate(dir_lists):
        edirs[i, : d.shape[0]] = d
        edcount[i] = d.shape[0]
    gmax = max((len(e) for e in edge_lists), default=1) or 1
    ei0 = np.zeros((hcount, gmax), np.int32)
    ei1 = np.zeros((hcount, gmax), np.int32)
    ecount = np.zeros(hcount, np.int32)
    for i, es in enumerate(edge_lists):
        for k, (a, b) in enumerate(es):
            ei0[i, k] = a
            ei1[i, k] = b
        if es:
            ei0[i, len(es):] = es[0][0]
            ei1[i, len(es):] = es[0][1]
        ecount[i] = len(es)

    return {
        "verts": verts, "vert_count": vcount, "face_normals": normals,
        "face_offsets": offsets, "face_count": fcount, "face_verts": fverts,
        "face_vert_count": fvcount, "edge_dirs": edirs,
        "edge_dir_count": edcount, "edge_i0": ei0, "edge_i1": ei1,
        "edge_count": ecount,
    }
