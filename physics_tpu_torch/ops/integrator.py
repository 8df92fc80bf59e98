"""Semi-implicit Euler, split into a velocity and a position phase
(physics_tpu/ops/integrator.py, non-compat branch): world-frame inverse
inertia, exponential-map rotation, optional quaternion renormalization."""

from __future__ import annotations

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import quaternion as quat
from physics_tpu_torch.state import SimState


def _no_compat(cfg: SimConfig):
    if cfg.compat:
        raise NotImplementedError(
            "compat integration (quirks Q2/Q4/Q6) is ROADMAP item 1.11")


def _mv(m, v):
    return torch.sum(m * v[:, None, :], dim=-1)


def _mtv(m, v):
    return torch.sum(m * v[:, :, None], dim=-2)


def integrate_velocities(state: SimState, cfg: SimConfig) -> SimState:
    _no_compat(cfg)
    dt = cfg.dt
    vel = state.vel + state.force * (state.inv_mass[:, None] * dt)
    rot = quat.to_matrix(state.quat)
    torque = state.torque
    if cfg.gyroscopic:
        l_w = _mv(rot, _mv(state.inertia, _mtv(rot, state.omega)))
        torque = torque - torch.cross(state.omega, l_w, dim=-1)
    omega = state.omega + _mv(
        rot, _mv(state.inv_inertia, _mtv(rot, torque * dt)))
    if cfg.max_velocity > 0.0:
        vel = torch.clamp(vel, -cfg.max_velocity, cfg.max_velocity)
        omega = torch.clamp(omega, -cfg.max_velocity, cfg.max_velocity)
    return state.replace(vel=vel, omega=omega)


def integrate_positions(state: SimState, cfg: SimConfig) -> SimState:
    _no_compat(cfg)
    dt = cfg.dt
    pos = state.pos + state.vel * dt
    q = quat.mul(quat.exp_map(state.omega * dt), state.quat)
    if cfg.renormalize_quat:
        q = quat.normalize(q)
    return state.replace(
        pos=pos,
        quat=q,
        force=torch.zeros_like(state.force),
        torque=torch.zeros_like(state.torque),
        step_count=state.step_count + 1,
        step_count_host=state.step_count_host + 1,
    )
