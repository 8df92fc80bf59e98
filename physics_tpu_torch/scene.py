"""Host-side scene construction (the SceneBuilder subset the box scenes
use: bodies and boxes; no joints, spheres or hulls).

Bodies accumulate in numpy lists; `build` assembles the state arrays and
sends them to the device in one copy (state.state_from_arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from physics_tpu_torch.state import SHAPE_BOX, SHAPE_NONE, SimState
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
    """Accumulates bodies and box shapes on the host, then `build()`s a
    SimState on a device."""

    def __init__(self):
        self._pos, self._quat, self._vel, self._omega = [], [], [], []
        self._mass, self._inertia = [], []
        self._stype, self._sparams = [], []
        self._friction, self._restitution = [], []

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
        self._friction.append(0.5)
        self._restitution.append(0.0)
        return len(self._pos) - 1

    def set_box(self, body: int, half_extents, friction=0.5,
                restitution=0.0):
        self._stype[body] = SHAPE_BOX
        self._sparams[body] = np.asarray(half_extents, np.float32)
        self._friction[body] = friction
        self._restitution[body] = restitution

    def build(self, device: torch.device | str = "cpu") -> SimState:
        n = len(self._pos)
        if n == 0:
            raise ValueError("scene has no bodies")
        shapes = {
            "stype": np.asarray(self._stype, np.int32),
            "params": np.stack(self._sparams),
            "hull_index": np.full((n,), -1, np.int32),
            "friction": np.asarray(self._friction, np.float32),
            "restitution": np.asarray(self._restitution, np.float32),
        }
        arrays = make_arrays(
            np.stack(self._pos), np.stack(self._quat), np.stack(self._vel),
            np.stack(self._omega), np.asarray(self._mass),
            np.stack(self._inertia), shapes)
        return state_from_arrays(arrays, device)
