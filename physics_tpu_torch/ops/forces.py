"""Per-step gravity (physics_tpu/ops/forces.py `apply_gravity`, non-compat
branch)."""

from __future__ import annotations

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.state import SimState


def apply_gravity(state: SimState, cfg: SimConfig) -> SimState:
    """F += m·g at the centre of mass; static bodies (inv_mass 0) get no
    force. The compat quirks (unscaled force at an offset) are ROADMAP
    item 1.11's, with the joints."""
    if cfg.compat or not cfg.gravity_scale_by_mass or any(
            v != 0.0 for v in cfg.gravity_offset):
        raise NotImplementedError(
            "compat gravity (unscaled / offset force) is ROADMAP item 1.11")
    # m·g per component with Python scalars: a g tensor made from the
    # config would be a host-to-device copy, which waits for the stream
    f = torch.stack([state.mass * g for g in cfg.gravity], dim=1)
    f = torch.where((state.inv_mass > 0.0)[:, None], f, torch.zeros_like(f))
    return state.replace(force=state.force + f)
