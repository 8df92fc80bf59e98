"""A pile of n boxes in `layers` layers laid out as a trench along x,
each jittered and tilted by the seed's draws: what the port's
scenes.box_pile(n, seed=seed, x_aspect=...) draws, in the same order."""

from __future__ import annotations

import numpy as np

from portbench.core.scene import boxes, quat_from_euler


def make(p: dict, seed: int) -> dict:
    n, half, layers = p["n_bodies"], p["half"], p["layers"]
    rng = np.random.default_rng(seed)
    per_layer = n // layers
    nz = max(int(np.sqrt(per_layer / p["x_aspect"])), 1)
    nx = per_layer // nz
    spacing = 2.6 * half
    # per body: uniform(-0.3h, 0.3h, 3) then uniform(-0.2, 0.2, 3)
    u = rng.random((n, 6))
    jitter = -0.3 * half + (0.6 * half) * u[:, :3]
    euler = -0.2 + 0.4 * u[:, 3:]
    i = np.arange(n)
    layer = i // (nx * nz)
    k = i - layer * nx * nz
    ix, iz = k % nx, k // nx
    pos = np.stack([
        ix * spacing + jitter[:, 0],
        half + layer * 2.2 * half + 0.01 * layer + np.abs(jitter[:, 1]),
        iz * spacing + jitter[:, 2],
    ], axis=1).astype(np.float32)
    return boxes(pos, quat_from_euler(euler.astype(np.float32)), p)
