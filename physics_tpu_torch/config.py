"""Simulation configuration (copy of physics_tpu.config.SimConfig).

The JAX package's module cannot be imported here: importing anything under
`physics_tpu` runs its `__init__`, which imports `state.py` and with it
`jax`. So the dataclass is copied field for field, and
`tests/test_torch_config_scene.py` pins the names and defaults to the
original.

Knobs that only shape the TPU kernels' tiling or precision are accepted and
ignored by this port, which computes in f32 everywhere:

  * `pallas_tile`, `pallas_window` — TPU contact-tile and body-window
    widths; the CUDA solve indexes bodies directly.
  * `z_bf16` — single-pass bf16 velocity-table movement in the TPU solve.
  * `solve_chunks` — streaming passes that fit the TPU solve in VMEM.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters. See physics_tpu/config.py for the
    meaning of every field; the names and defaults are identical."""

    # time stepping
    dt: float = 1.0 / 60.0

    # gravity
    gravity: tuple = (0.0, -9.81, 0.0)
    gravity_offset: tuple = (0.0, 0.0, 0.0)
    gravity_scale_by_mass: bool = True

    # behaviour flags
    compat: bool = False

    # joint solver (CG)
    cg_max_iters: int = 1000
    cg_rel_tol: float = 1e-2
    cg_abs_tol: float = 1e-3

    # contact pipeline
    ground_plane: bool = False
    ground_height: float = 0.0
    pair_collisions: bool = False
    contact_iters: int = 24
    position_iters: int = 8
    contact_relaxation: float = 1.0
    baumgarte: float = 0.2
    penetration_slop: float = 0.005
    restitution: float = 0.0
    friction: float = 0.5
    max_contacts_per_pair: int = 8
    max_contacts: int = 0
    boxes_only: bool = False
    hulls_only: bool = False
    hull_fast: bool = True
    hull_prefilter_cap: int = 0
    broadphase: str = "allpairs"
    sweep_window: int = 32
    max_pair_candidates: int = 0
    env_block_size: int = 0
    pair_buckets: bool = False
    bucket_block: int = 64
    bucket_cap: int = 0

    # contact solver backend
    contact_solver: str = "jacobi"
    pallas_tile: int = 1024           # ignored by the port (TPU tiling)
    pallas_window: int = 512          # ignored by the port (TPU tiling)
    narrowphase_pallas: bool = True
    contact_table: bool = False
    bucket_ccap: int = 0
    bucket_cap2: int = 0
    bp_inkernel: bool = False
    fuse_integrate: bool = False
    fuse_prep: bool = False
    hull_table: bool = False
    contact_rebuild: int = 1
    contact_rebuild_vel_factor: float = 2.0
    contact_refresh_iters: int = 0
    z_bf16: bool = False              # ignored by the port (always f32)
    solve_chunks: int = 0             # ignored by the port (VMEM policy)

    # integrator extras (non-compat mode)
    renormalize_quat: bool = True
    gyroscopic: bool = False
    max_velocity: float = 0.0

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def compat_config(**overrides) -> SimConfig:
    """The reference demo's semantics (physics_tpu.config.compat_config):
    compat mode (quirks Q1–Q7), gravity as an unscaled force at the
    offset (0, 0, 1.5), no ground plane, no renormalisation."""
    base = dict(
        compat=True,
        gravity=(0.0, -9.81, 0.0),
        gravity_offset=(0.0, 0.0, 1.5),
        gravity_scale_by_mass=False,
        renormalize_quat=False,
        ground_plane=False,
    )
    base.update(overrides)
    return SimConfig(**base)
