"""Semi-implicit Euler, split into a velocity and a position phase
(physics_tpu/ops/integrator.py).

compat reproduces the reference engine's integrator with its quirks:
v += (F / m)·dt; ω += I⁻¹(τ·dt) with the body-frame inertia inverted
every step by the adjugate (Q4); the rotation step exp(ω̂·sin(|ω|dt/2))
(Q2), applied only where ω is not exactly zero (Q6); no
renormalisation. Otherwise: the stored inv_mass, the world-frame inverse
inertia R·I⁻¹·Rᵀ, the exponential map exp(ω·dt), optional gyroscopic
term, velocity clamp and quaternion renormalisation."""

from __future__ import annotations

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import quaternion as quat
from physics_tpu_torch.maths.linalg import inv3x3
from physics_tpu_torch.state import SimState


def _mv(m, v):
    return torch.sum(m * v[:, None, :], dim=-1)


def _mtv(m, v):
    return torch.sum(m * v[:, :, None], dim=-2)


def integrate_velocities(state: SimState, cfg: SimConfig) -> SimState:
    dt = cfg.dt
    if cfg.compat:
        # (F / m)·dt in this order (the reference's rounding)
        vel = state.vel + state.force / state.mass[:, None] * dt
        omega = state.omega + _mv(inv3x3(state.inertia), state.torque * dt)
        return state.replace(vel=vel, omega=omega)
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
    dt = cfg.dt
    pos = state.pos + state.vel * dt
    if cfg.compat:
        nonzero = torch.any(state.omega != 0.0, dim=-1)
        norm = torch.sqrt(torch.sum(state.omega * state.omega, dim=-1))
        safe_norm = torch.where(nonzero, norm, torch.ones_like(norm))
        axis = state.omega / safe_norm[:, None]
        theta = norm * dt
        rotvec = axis * torch.sin(theta * 0.5)[:, None]
        q_new = quat.mul(quat.exp_map(rotvec), state.quat)
        q = torch.where(nonzero[:, None], q_new, state.quat)
    else:
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
