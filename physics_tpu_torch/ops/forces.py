"""Per-step gravity (physics_tpu/ops/forces.py `apply_gravity`)."""

from __future__ import annotations

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.state import SimState


def apply_gravity(state: SimState, cfg: SimConfig) -> SimState:
    """F += m·g at the centre of mass (static bodies, inv_mass 0, get no
    force), or with gravity_scale_by_mass off F += g unscaled; with a
    non-zero gravity_offset also τ += offset × F. compat_config takes the
    unscaled force at (0, 0, 1.5), quirk Q5: the demo's swing torque.

    The config's numbers stay Python scalars (each rounds to f32 in the
    operation, as an f32 tensor of them would): a tensor made from the
    config would be a host-to-device copy, which waits for the stream."""
    if cfg.gravity_scale_by_mass:
        f = torch.stack([state.mass * g for g in cfg.gravity], dim=1)
        f = torch.where((state.inv_mass > 0.0)[:, None], f,
                        torch.zeros_like(f))
    else:
        f = torch.stack([torch.full_like(state.mass, g)
                         for g in cfg.gravity], dim=1)
    state = state.replace(force=state.force + f)
    if not any(v != 0.0 for v in cfg.gravity_offset):
        return state
    ox, oy, oz = cfg.gravity_offset
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    tau = torch.stack([oy * fz - oz * fy, oz * fx - ox * fz,
                       ox * fy - oy * fx], dim=1)
    return state.replace(torque=state.torque + tau)
