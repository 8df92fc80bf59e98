"""What every scene builder shares (scenes/<builder>.py): the arrays of a
scene of boxes, made on the host in a few vectorised numpy calls.

A builder's `make(params, seed)` returns the scene's arrays, which the
program and the reference both take: pos [N, 3], quat [N, 4] (w, x, y,
z), mass [N], inertia [N, 3, 3] and `shapes`, a dict of the shape kind
("box": the port's SHAPE_BOX), params [N, 3] (a box's half extents),
friction [N] and restitution [N], with `hulls` and `joints` where the
scene has them (the port's make_arrays). A builder whose envs are reset
also has `reset_pool(params, seed, slots)`: (pos [M, N, 3], quat [M, N,
4]), the poses its bodies take at their resets."""

from __future__ import annotations

import numpy as np


def quat_from_euler(e: np.ndarray) -> np.ndarray:
    """Quaternions (w, x, y, z) [..., 4] f32 from roll-pitch-yaw [..., 3]
    f32, R = Rz·Ry·Rx (the port's scene._from_euler_np, vectorised)."""
    e = np.asarray(e, np.float32)
    hr, hp, hy = e[..., 0] * 0.5, e[..., 1] * 0.5, e[..., 2] * 0.5
    sr, cr = np.sin(hr), np.cos(hr)
    sp, cp = np.sin(hp), np.cos(hp)
    sy, cy = np.sin(hy), np.cos(hy)
    return np.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], axis=-1).astype(np.float32)


def box_inertia(half: float, mass: float) -> np.ndarray:
    """The solid box's inertia about its centre (io/meshes.box_inertia)."""
    h2 = float(half) * float(half)
    m = float(mass)
    return np.diag([m / 3.0 * (h2 + h2)] * 3).astype(np.float32)


def boxes(pos, quat, p: dict) -> dict:
    """The arrays of N equal boxes (p: half, mass, friction, restitution)
    at pos/quat."""
    n = pos.shape[0]
    f32 = np.float32
    return {
        "pos": np.asarray(pos, f32), "quat": np.asarray(quat, f32),
        "mass": np.full((n,), p["mass"], f32),
        "inertia": np.broadcast_to(box_inertia(p["half"], p["mass"]),
                                   (n, 3, 3)).copy(),
        "shapes": {"kind": "box",
                   "params": np.full((n, 3), p["half"], f32),
                   "friction": np.full((n,), p["friction"], f32),
                   "restitution": np.full((n,), p["restitution"], f32)},
    }
