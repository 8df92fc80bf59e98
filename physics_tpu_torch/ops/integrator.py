"""Semi-implicit Euler, split into a velocity and a position phase
(physics_tpu/ops/integrator.py).

compat reproduces the reference engine's integrator with its quirks:
v += (F / m)·dt; ω += I⁻¹(τ·dt) with the body-frame inertia inverted
every step by the adjugate (Q4); the rotation step exp(ω̂·sin(|ω|dt/2))
(Q2), applied only where ω is not exactly zero (Q6); no
renormalisation. Otherwise: the stored inv_mass, the world-frame inverse
inertia R·I⁻¹·Rᵀ, the exponential map exp(ω·dt), optional gyroscopic
term, velocity clamp and quaternion renormalisation.

gravity_and_velocities runs apply_gravity and the non-compat velocity
phase as one launch of csrc/body_forces.cu on a CUDA state."""

from __future__ import annotations

import ctypes

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import quaternion as quat
from physics_tpu_torch.maths.linalg import inv3x3
from physics_tpu_torch.ops.forces import apply_gravity
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


def gravity_and_velocities(state: SimState, cfg: SimConfig,
                           gravity: bool = True, integrate: bool = True,
                           plain: bool = False) -> SimState:
    """apply_gravity (`gravity`), then integrate_velocities (`integrate`),
    for a non-compat config: the step's work before the contacts, with
    the joint solve between the two halves where there are joints.

    A CPU tensor (or `plain=True`) runs those two functions, the plain
    version; a CUDA tensor launches csrc/body_forces.cu once, bit for bit
    the same: it writes force and torque (gravity; torque only under a
    non-zero gravity_offset, else the state keeps its tensor) and vel and
    omega (integrate). compat raises: its quirks Q4/Q5 are the plain
    functions' own route, which the kernel does not take.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    if cfg.compat:
        raise ValueError("gravity_and_velocities: a compat config takes "
                         "apply_gravity and integrate_velocities")
    if not (gravity or integrate):
        raise ValueError("gravity_and_velocities: neither gravity nor "
                         "integrate")
    if plain or state.device.type == "cpu":
        if gravity:
            state = apply_gravity(state, cfg)
        if integrate:
            state = integrate_velocities(state, cfg)
        return state
    if state.device.type != "cuda":
        raise ValueError(f"gravity_and_velocities: unsupported device "
                         f"{state.device}")
    return _launch_body_forces(state, cfg, gravity, integrate)


gravity_and_velocities.launches = 0


def _launch_body_forces(state: SimState, cfg: SimConfig, gravity: bool,
                        integrate: bool) -> SimState:
    from physics_tpu_torch import _build

    n, dev = state.num_bodies, state.device
    f32 = torch.float32
    offset = any(v != 0.0 for v in cfg.gravity_offset)
    gyro = integrate and cfg.gyroscopic
    ops = [("mass", state.mass.contiguous(), (n,)),
           ("inv_mass", state.inv_mass.contiguous(), (n,)),
           ("force", state.force.contiguous(), (n, 3)),
           ("torque", state.torque.contiguous(), (n, 3)),
           ("vel", state.vel.contiguous(), (n, 3)),
           ("omega", state.omega.contiguous(), (n, 3)),
           ("quat", state.quat.contiguous(), (n, 4)),
           ("inv_inertia", state.inv_inertia.contiguous(), (n, 3, 3))]
    if gyro:
        ops.append(("inertia", state.inertia.contiguous(), (n, 3, 3)))
    _build.check_operands("body forces", dev,
                          *[(k, x, f32, shape) for k, x, shape in ops])
    t = {k: x for k, x, _ in ops}
    out = {}
    if gravity:
        out["force"] = torch.empty((n, 3), dtype=f32, device=dev)
        if offset:
            out["torque"] = torch.empty((n, 3), dtype=f32, device=dev)
    if integrate:
        out["vel"] = torch.empty((n, 3), dtype=f32, device=dev)
        out["omega"] = torch.empty((n, 3), dtype=f32, device=dev)
    flags = ((_build.BF_GRAVITY if gravity else 0)
             | (_build.BF_INTEGRATE if integrate else 0)
             | (_build.BF_SCALE_BY_MASS if cfg.gravity_scale_by_mass else 0)
             | (_build.BF_OFFSET if offset else 0)
             | (_build.BF_GYROSCOPIC if gyro else 0)
             | (_build.BF_CLAMP if cfg.max_velocity > 0.0 else 0))

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)
    with torch.cuda.device(dev):
        err = _build.library().bf_body_forces(
            *[ptr(t.get(k)) for k in (
                "mass", "inv_mass", "force", "torque", "vel", "omega",
                "quat", "inv_inertia", "inertia")],
            *[ptr(out.get(k)) for k in ("force", "torque", "vel", "omega")],
            *cfg.gravity, *cfg.gravity_offset, cfg.dt, cfg.max_velocity,
            n, flags,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "bf_body_forces")
    gravity_and_velocities.launches += 1
    return state.replace(**out)


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
