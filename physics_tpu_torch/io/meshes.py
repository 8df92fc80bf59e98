"""Mass properties (the subset of physics_tpu/io/meshes.py the box scenes
use)."""

from __future__ import annotations

import numpy as np


def box_inertia(half_extents, mass: float) -> np.ndarray:
    """Solid-box inertia tensor about its COM."""
    hx, hy, hz = [float(h) for h in half_extents]
    m = float(mass)
    return np.diag([
        m / 3.0 * (hy * hy + hz * hz),
        m / 3.0 * (hx * hx + hz * hz),
        m / 3.0 * (hx * hx + hy * hy),
    ]).astype(np.float32)
