"""The box pile, the hull rains and the packed environments with their
production configs (physics_tpu/scenes.py `box_pile`, `pile_config`,
`mesh_rain`, `mesh_rain_mixed`, `rain_config`, `rain_xla_config`,
`random_env`; the packed
4096×8 configuration and scene of bench.py `bench_batched_envs`). The
same numpy draws in the same order give the same scenes as the JAX
package. Every scene is built on the card unless the caller passes
device="cpu" (state.resolve_device)."""

from __future__ import annotations

import numpy as np
import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.envs import offset_envs, pack_envs
from physics_tpu_torch.io.meshes import box_inertia, sphere_inertia
from physics_tpu_torch.io.primitives import beveled_cube_mesh
from physics_tpu_torch.scene import SceneBuilder
from physics_tpu_torch.state import SimState


def box_pile(
    n_bodies: int = 4096,
    half: float = 0.5,
    seed: int = 0,
    layers: int = 4,
    x_aspect: float = 16.0,
    device: torch.device | str = "cuda",
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


def _check_procedural(real_assets: bool | None) -> None:
    if real_assets:
        raise NotImplementedError(
            "the real cube asset (res/cube.obj through io/assets.py, "
            "io/objloader.py and plane_cut_hull) is not in the repository; "
            "the port's rain uses the procedural bevelled cube, as the JAX "
            "package does without the files (ROADMAP item 1.16)")


def _rain_grid(b: SceneBuilder, n_bodies: int, size: float, rng,
               body_hull):
    """The rain column: square layers of `side`² bodies, 2.5·size apart,
    3·size between layers, jittered and randomly oriented.
    `body_hull(count)` gives each body's (hull id, inertia)."""
    side = max(1, int(np.ceil(np.sqrt(n_bodies / 4))))
    count = 0
    for layer in range(10**9):
        if count >= n_bodies:
            break
        for gx in range(side):
            for gz in range(side):
                if count >= n_bodies:
                    break
                jitter = rng.uniform(-0.2, 0.2, 3)
                hull, inertia = body_hull(count)
                i = b.add_body(
                    pos=(
                        (gx - side / 2) * 2.5 * size + jitter[0],
                        1.5 * size + layer * 3.0 * size + jitter[1],
                        (gz - side / 2) * 2.5 * size + jitter[2],
                    ),
                    euler=rng.uniform(-1.5, 1.5, 3),
                    inertia=inertia,
                )
                b.set_hull(i, hull, friction=0.4, restitution=0.05)
                count += 1


def mesh_rain(n_bodies: int = 128, seed: int = 0, size: float = 0.5,
              bevel: float = 0.1, real_assets: bool | None = None,
              device: torch.device | str = "cuda") -> SimState:
    """Convex-hull bevelled cubes raining onto the ground: every body is
    the procedural bevel-edged cube (24 vertices, 26 faces) as a convex
    hull, randomly oriented, falling from a column. `real_assets=True`
    (the reference's res/cube.obj) raises; None means procedural."""
    _check_procedural(real_assets)
    rng = np.random.default_rng(seed)
    verts, _ = beveled_cube_mesh(size=size, bevel=bevel)
    inertia = box_inertia((size,) * 3, 1.0)
    b = SceneBuilder()
    hull = b.add_hull(verts)
    _rain_grid(b, n_bodies, size, rng, lambda count: (hull, inertia))
    return b.build(device)


def mesh_rain_mixed(n_bodies: int = 128, seed: int = 0, size: float = 0.5,
                    real_assets: bool | None = None, n_types: int = 2,
                    device: torch.device | str = "cuda") -> SimState:
    """Multi-hull-type rain: bodies cycle through `n_types` distinct hull
    shapes (bevel cube, octahedron, and at n_types=3 a wedge prism)."""
    _check_procedural(real_assets)
    rng = np.random.default_rng(seed)
    cube_verts, _ = beveled_cube_mesh(size=size, bevel=0.1 * size / 0.5)
    cube_inertia = box_inertia((size,) * 3, 1.0)
    s = 1.3 * size
    octa_verts = np.array(
        [[s, 0, 0], [-s, 0, 0], [0, s, 0], [0, -s, 0],
         [0, 0, s], [0, 0, -s]], np.float32)
    octa_inertia = sphere_inertia(0.7 * s, 1.0)
    # the wedge is not centred on its centre of mass; kept as the JAX
    # package has it, so both packages build the same scene
    wedge_verts = np.array(
        [[s, -0.5 * s, 0.8 * s], [s, -0.5 * s, -0.8 * s],
         [-s, -0.5 * s, 0.8 * s], [-s, -0.5 * s, -0.8 * s],
         [s, 0.7 * s, 0.0], [-s, 0.7 * s, 0.0]], np.float32)
    wedge_inertia = box_inertia((s, 0.6 * s, 0.8 * s), 1.0)
    if not 2 <= n_types <= 3:
        raise ValueError(f"mesh_rain_mixed supports 2-3 types, got {n_types}")

    b = SceneBuilder()
    hull_ids = [b.add_hull(cube_verts), b.add_hull(octa_verts)]
    inertias = [cube_inertia, octa_inertia]
    if n_types >= 3:
        hull_ids.append(b.add_hull(wedge_verts))
        inertias.append(wedge_inertia)
    _rain_grid(b, n_bodies, size, rng,
               lambda count: (hull_ids[count % n_types],
                              inertias[count % n_types]))
    return b.build(device)


def hull_rain(verts, n_bodies: int = 128, seed: int = 0, size: float = 0.5,
              device: torch.device | str = "cuda") -> SimState:
    """mesh_rain's column of one convex hull given by its body-frame
    vertices (any face sizes; io/primitives prism_verts, octahedron_verts),
    with the box inertia of half extent `size`."""
    rng = np.random.default_rng(seed)
    inertia = box_inertia((size,) * 3, 1.0)
    b = SceneBuilder()
    hull = b.add_hull(np.asarray(verts, np.float32))
    _rain_grid(b, n_bodies, size, rng, lambda count: (hull, inertia))
    return b.build(device)


def rain_config(n_bodies: int, dt: float = 1.0 / 60.0) -> SimConfig:
    """The production rain pipeline: bucketed sweep (window 32, 12N
    candidates), the fused hull contact table (OBB prefilter to 512 lanes
    per bucket, 4 points per pair, 16N contacts), the fused banded solve
    with 8 sweeps, anchored rebuild every 4th step with a 4-sweep refresh
    and no motion guard (see physics_tpu/scenes.py for the measurements
    behind each value). `z_bf16` is set as in the JAX config and ignored
    by the port."""
    return SimConfig(
        compat=False,
        ground_plane=True,
        pair_collisions=True,
        hulls_only=True,
        broadphase="sweep",
        sweep_window=32,
        max_pair_candidates=12 * n_bodies,
        hull_prefilter_cap=4 * n_bodies,
        max_contacts_per_pair=4,
        max_contacts=16 * n_bodies,
        contact_solver="pallas_banded",
        pair_buckets=True,
        bucket_block=128,
        contact_table=True,
        hull_table=True,
        bucket_cap2=512,
        fuse_prep=True,
        fuse_integrate=True,
        contact_rebuild=4,
        contact_rebuild_vel_factor=0.0,
        contact_refresh_iters=4,
        contact_iters=8,
        z_bf16=True,
        dt=dt,
    )


def rain_xla_config(n_bodies: int, dt: float = 1.0 / 60.0) -> SimConfig:
    """The pre-adoption generic-path rain config: XLA shared-hull fast
    paths (slot-major SAT contractions + OBB prefilter) feeding the
    banded solve, no fused table/anchoring. Kept as the parity/A-B
    partner for the production hull-table pipeline (rain_config) — the
    table tests assert the two produce the same contact sets."""
    return rain_config(n_bodies, dt).replace(
        pair_buckets=False, bucket_block=64, bucket_cap2=0,
        contact_table=False, hull_table=False,
        fuse_prep=False, fuse_integrate=False,
        contact_rebuild=1, contact_refresh_iters=0,
    )


def random_env(seed: int, n_bodies: int = 8,
               device: torch.device | str = "cuda") -> SimState:
    """One randomized small scene of 0.4-half-extent boxes (the unit of
    the batched-environments configuration)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for _ in range(n_bodies):
        i = b.add_body(
            pos=rng.uniform([-3, 1, -3], [3, 6, 3]),
            euler=rng.uniform(-1, 1, 3),
            inertia=box_inertia((0.4,) * 3, 1.0),
        )
        b.set_box(i, (0.4,) * 3, friction=0.5)
    return b.build(device)


def packed_envs(n_envs: int = 4096, n_bodies: int = 8,
                device: torch.device | str = "cuda") -> SimState:
    """The packed-environments scene of bench.py `bench_batched_envs`:
    random_env(0, n_bodies) in each of n_envs envs, env e shifted by the
    e-th offset of default_rng(1).uniform(-1, 1, (n_envs, 1, 3)), packed
    into one scene of n_envs·n_bodies bodies (envs.pack_envs; call
    engine.prepare_contacts on it)."""
    base = random_env(0, n_bodies, device)
    rng = np.random.default_rng(1)
    offsets = rng.uniform(-1, 1, (n_envs, 1, 3)).astype(np.float32)
    return pack_envs(offset_envs(base, torch.from_numpy(offsets).to(
        base.device)))


def packed_env_config(n_envs: int = 4096, n_bodies: int = 8,
                      dt: float = 1.0 / 60.0) -> SimConfig:
    """The packed-environments pipeline of bench.py `bench_batched_envs`:
    env_blocks with the in-kernel broad phase (identity order, same-env
    pairs, no sort), the fused contact table and solve, 48 contacts an
    env, and the anchored rebuild every 32nd step with the per-bucket
    displacement gate (vel_factor 2) and a 4-sweep refresh. `z_bf16` is
    set as in the JAX config and ignored by the port."""
    return SimConfig(
        compat=False, ground_plane=True, pair_collisions=True,
        contact_iters=8, dt=dt, boxes_only=True,
        broadphase="env_blocks", env_block_size=n_bodies,
        contact_solver="pallas_banded",
        max_contacts=48 * n_envs,
        contact_table=True, bp_inkernel=True, bucket_block=128,
        z_bf16=True,
        fuse_prep=True, fuse_integrate=True,
        contact_rebuild=32, contact_refresh_iters=4,
        contact_rebuild_vel_factor=2.0,
    )
