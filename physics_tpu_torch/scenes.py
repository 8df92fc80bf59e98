"""The box pile scene and its production config (physics_tpu/scenes.py
`box_pile`, `pile_config`). The same numpy draws in the same order give
the same scene as the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.io.meshes import box_inertia
from physics_tpu_torch.scene import SceneBuilder
from physics_tpu_torch.state import SimState


def box_pile(
    n_bodies: int = 4096,
    half: float = 0.5,
    seed: int = 0,
    layers: int = 4,
    x_aspect: float = 16.0,
    device: torch.device | str = "cpu",
) -> SimState:
    """N-body box pile dropped above the ground plane, laid out as a long
    trench along x so the sort-by-x sweep keeps a low window density."""
    rng = np.random.default_rng(seed)
    per_layer = n_bodies // layers
    nz = max(int(np.sqrt(per_layer / x_aspect)), 1)
    nx = per_layer // nz
    spacing = 2.6 * half

    b = SceneBuilder()
    count = 0
    layer = 0
    while count < n_bodies:
        k = count - layer * nx * nz
        if k >= nx * nz:
            layer += 1
            k = 0
        ix, iz = k % nx, k // nx
        jitter = rng.uniform(-0.3 * half, 0.3 * half, 3)
        pos = (
            ix * spacing + jitter[0],
            half + layer * 2.2 * half + 0.01 * layer + abs(jitter[1]),
            iz * spacing + jitter[2],
        )
        i = b.add_body(
            pos=pos,
            euler=rng.uniform(-0.2, 0.2, 3),
            inertia=box_inertia((half,) * 3, 1.0),
        )
        b.set_box(i, (half,) * 3, friction=0.5)
        count += 1
    return b.build(device)


def pile_config(n_bodies: int, dt: float = 1.0 / 60.0) -> SimConfig:
    """The production pile pipeline: fused contact table, banded solve,
    anchored rebuild every 4th step (see physics_tpu/scenes.py for the
    measurements behind each value). `z_bf16` is set as in the JAX
    config and ignored by the port."""
    return SimConfig(
        compat=False,
        ground_plane=True,
        pair_collisions=True,
        boxes_only=True,
        contact_solver="pallas_banded",
        broadphase="sweep",
        sweep_window=48,
        max_pair_candidates=8 * n_bodies,
        pair_buckets=True,
        contact_table=True,
        bucket_block=128,
        bucket_cap2=384,
        z_bf16=True,
        fuse_prep=True,
        fuse_integrate=True,
        contact_rebuild=4,
        contact_rebuild_vel_factor=0.0,
        contact_refresh_iters=4,
        max_contacts_per_pair=4,
        max_contacts=6 * n_bodies,
        contact_iters=16,
        pallas_window=384,
        dt=dt,
    )
