"""NumPy oracle: op-for-op reimplementation of the reference engine, the
golden trajectory of the demo scene (a copy of
physics_tpu/oracle/reference.py: importing anything under physics_tpu
runs its __init__, which imports jax, so the port keeps its own copy;
tests/test_torch_demo.py holds the two copies to the same numbers).

Every operation mirrors the reference source line by line in f32 —

  * RigidBody::step                 reference: src/physics/rigid_body.rs:24-40
  * apply_force_at_offset gravity   reference: src/physics.rs:87-94
  * ConstraintSolver::solve_constraints  reference: src/physics/constraints.rs:67-169
  * FixToPointConstraint            reference: fixed_position_constraint.rs:13-31
  * FixedOrientationConstraint      reference: fixed_orientation_constraint.rs:15-34
  * CG solver                       reference: src/physics/sle_solver.rs:21-51
  * PhysicsState::update            reference: src/physics.rs:41-55
    including quirk Q1 (constraint force applied to entity 0 only).

The only deviation: α in CG is guarded against a 0/0 (the reference would
produce NaN there; see physics_tpu_torch/solver/cg.py).

Everything here is float32 NumPy with nalgebra-matching formulas
(quaternion (w,x,y,z), euler = roll-pitch-yaw).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

F32 = np.float32


# --------------------------------------------------------------------- quats
def quat_identity():
    return np.array([1.0, 0.0, 0.0, 0.0], F32)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        F32,
    )


def quat_from_euler(roll, pitch, yaw):
    roll, pitch, yaw = F32(roll), F32(pitch), F32(yaw)
    sr, cr = np.sin(roll * F32(0.5)), np.cos(roll * F32(0.5))
    sp, cp = np.sin(pitch * F32(0.5)), np.cos(pitch * F32(0.5))
    sy, cy = np.sin(yaw * F32(0.5)), np.cos(yaw * F32(0.5))
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        F32,
    )


def quat_to_matrix(q):
    w, x, y, z = q
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    xy = x * y * F32(2)
    wz = w * z * F32(2)
    wy = w * y * F32(2)
    xz = x * z * F32(2)
    yz = y * z * F32(2)
    wx = w * x * F32(2)
    return np.array(
        [
            [ww + xx - yy - zz, xy - wz, wy + xz],
            [wz + xy, ww - xx + yy - zz, yz - wx],
            [xz - wy, wx + yz, ww - xx - yy + zz],
        ],
        F32,
    )


def quat_to_euler(q):
    """nalgebra Rotation3::euler_angles (Slabaugh), f32."""
    r = quat_to_matrix(q)
    if abs(r[2, 0]) < 1.0:
        pitch = -np.arcsin(r[2, 0])
        cp = np.cos(pitch)
        roll = np.arctan2(r[2, 1] / cp, r[2, 2] / cp)
        yaw = np.arctan2(r[1, 0] / cp, r[0, 0] / cp)
        return np.array([roll, pitch, yaw], F32)
    elif r[2, 0] <= -1.0:
        return np.array(
            [np.arctan2(r[0, 1], r[0, 2]), np.pi / 2, 0.0], F32
        )
    else:
        return np.array(
            [np.arctan2(-r[0, 1], -r[0, 2]), -np.pi / 2, 0.0], F32
        )


def quat_from_scaled_axis(v):
    """nalgebra UnitQuaternion::new(v): exp map, identity at ‖v‖=0."""
    v = np.asarray(v, F32)
    n = F32(np.sqrt(np.sum(v * v, dtype=F32)))
    if n == 0.0:
        return quat_identity()
    half = n * F32(0.5)
    return np.concatenate(
        [[np.cos(half)], v * (np.sin(half) / n)]
    ).astype(F32)


def inv3x3(m):
    """nalgebra Matrix3 inverse (adjugate/det), f32."""
    m = np.asarray(m, F32)
    a, b, c = m[0]
    d, e, f = m[1]
    g, h, i = m[2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = np.array(
        [
            [co_a, c * h - b * i, b * f - c * e],
            [co_b, a * i - c * g, c * d - a * f],
            [co_c, b * g - a * h, a * e - b * d],
        ],
        F32,
    )
    return adj / det


# --------------------------------------------------------------------- bodies
@dataclass
class OracleBody:
    """reference: src/physics/rigid_body.rs:5-21, defaults :64-76."""

    mass: F32 = F32(1.0)
    lin_velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    angular_velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    force: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    torque: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    inertia_tensor: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=F32))
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    rotation: np.ndarray = field(default_factory=quat_identity)

    def apply_force_at_offset(self, force, offset):
        force = np.asarray(force, F32)
        offset = np.asarray(offset, F32)
        self.torque = (self.torque + np.cross(offset, force)).astype(F32)
        self.force = (self.force + force).astype(F32)

    def step(self, dt: float):
        dt = F32(dt)
        self.lin_velocity = (
            self.lin_velocity + self.force / self.mass * dt
        ).astype(F32)
        self.position = (self.position + self.lin_velocity * dt).astype(F32)

        angular_momentum = (self.torque * dt).astype(F32)
        self.angular_velocity = (
            self.angular_velocity + inv3x3(self.inertia_tensor) @ angular_momentum
        ).astype(F32)
        if np.any(self.angular_velocity != 0.0):
            norm = F32(
                np.sqrt(np.sum(self.angular_velocity * self.angular_velocity,
                               dtype=F32))
            )
            a = (self.angular_velocity / norm).astype(F32)
            theta = norm * dt
            dq = quat_from_scaled_axis(a * np.sin(theta * F32(0.5)))
            self.rotation = quat_mul(dq, self.rotation)
        self.force = np.zeros(3, F32)
        self.torque = np.zeros(3, F32)


# ----------------------------------------------------------------- constraints
@dataclass
class OracleFixToPoint:
    """reference: fixed_position_constraint.rs (KS=10, KD=1)."""

    rigid_body: int
    position: np.ndarray
    ks: float = 10.0
    kd: float = 1.0

    def calculate(self, bodies):
        c = (bodies[self.rigid_body].position - np.asarray(self.position, F32)
             ).astype(F32)
        j = np.zeros((3, 12), F32)
        j[0, 0] = j[1, 1] = j[2, 2] = 1.0
        j_dot = np.zeros((3, 12), F32)
        return c, j, j_dot, np.full(3, F32(self.ks)), np.full(3, F32(self.kd))

    count = 3

    def bodies_idx(self):
        return [self.rigid_body]


@dataclass
class OracleFixedOrientation:
    """reference: fixed_orientation_constraint.rs (target = euler angles)."""

    rigid_body: int
    position: np.ndarray
    ks: float = 10.0
    kd: float = 1.0

    def calculate(self, bodies):
        delta = quat_to_euler(bodies[self.rigid_body].rotation)
        c = (delta - np.asarray(self.position, F32)).astype(F32)
        j = np.zeros((3, 12), F32)
        j[0, 3] = j[1, 4] = j[2, 5] = 1.0
        j_dot = np.zeros((3, 12), F32)
        return c, j, j_dot, np.full(3, F32(self.ks)), np.full(3, F32(self.kd))

    count = 3

    def bodies_idx(self):
        return [self.rigid_body]


def _solve_cg(a_fn, rhs, previous, max_iters=1000, max_error=1e-2, min_error=1e-3):
    """reference: sle_solver.rs:21-46 (α guarded against 0/0, see module doc)."""
    x = previous.copy() if previous is not None else np.zeros_like(rhs)
    r = (rhs - a_fn(x)).astype(F32)
    p = r.copy()
    for _ in range(max_iters):
        jp = a_fn(p)
        rk = F32(np.dot(r, r))
        den = F32(np.dot(p, jp))
        alpha = rk / den if den != 0.0 else F32(0.0)
        x = (x + alpha * p).astype(F32)
        r = (r - alpha * jp).astype(F32)
        if np.max(np.abs(r)) < max(np.max(np.abs(rhs)) * F32(max_error),
                                   F32(min_error)):
            return x
        beta = F32(np.dot(r, r)) / rk if rk != 0.0 else F32(0.0)
        p = (r + beta * p).astype(F32)
    return None


class OracleScene:
    """reference: PhysicsState (src/physics.rs:25-31) + update (:41-55)."""

    def __init__(self, bodies: List[OracleBody], constraints: List,
                 gravity=(0.0, -9.81, 0.0), gravity_offset=(0.0, 0.0, 1.5)):
        self.bodies = bodies
        self.constraints = constraints
        self.previous_solution: Optional[np.ndarray] = None
        self.gravity = np.asarray(gravity, F32)
        self.gravity_offset = np.asarray(gravity_offset, F32)

    def apply_gravity(self):
        for b in self.bodies:
            b.apply_force_at_offset(self.gravity, self.gravity_offset)

    def solve_constraints(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.bodies)
        inv_masses = np.concatenate(
            [np.full(6, F32(1.0) / b.mass, F32) for b in self.bodies]
        )
        q_dot = np.concatenate(
            [np.concatenate([b.lin_velocity, b.angular_velocity])
             for b in self.bodies]
        ).astype(F32)
        f_ext = np.concatenate(
            [np.concatenate([b.force, b.torque]) for b in self.bodies]
        ).astype(F32)

        rows = sum(c.count for c in self.constraints)
        if rows == 0:
            return None
        j = np.zeros((rows, 6 * n), F32)
        j_dot = np.zeros((rows, 6 * n), F32)
        ks = np.zeros(rows, F32)
        kd = np.zeros(rows, F32)
        c_vec = np.zeros(rows, F32)
        ci = 0
        for con in self.constraints:
            c, jj, jjd, kks, kkd = con.calculate(self.bodies)
            cnt = con.count
            c_vec[ci:ci + cnt] = c
            ks[ci:ci + cnt] = kks
            kd[ci:ci + cnt] = kkd
            for slot, body in enumerate(con.bodies_idx()):
                j[ci:ci + cnt, body * 6:body * 6 + 6] = jj[:cnt, slot * 6:slot * 6 + 6]
                j_dot[ci:ci + cnt, body * 6:body * 6 + 6] = (
                    jjd[:cnt, slot * 6:slot * 6 + 6]
                )
            ci += cnt

        jd_qd = (-(j_dot @ q_dot)).astype(F32)
        c_dot = (j @ q_dot).astype(F32)
        kd_term = (kd * c_dot).astype(F32)
        ks_term = (ks * c_vec).astype(F32)
        rhs = (jd_qd - j @ (f_ext * inv_masses) - ks_term - kd_term).astype(F32)

        def a_fn(v):
            return (j @ ((j.T @ v) * inv_masses)).astype(F32)

        lam = _solve_cg(a_fn, rhs, self.previous_solution)
        if lam is None:
            return None
        return lam, (j.T @ lam).astype(F32)

    def update(self, dt: float):
        """reference: physics.rs:41-55 with quirk Q1 (entity 0 only)."""
        self.apply_gravity()
        result = self.solve_constraints()
        if result is not None:
            lam, jtl = result
            self.previous_solution = lam
            # Q1: matrix.column_iter() over a column vector yields ONE column
            # → only entities[0] receives force/torque (physics.rs:47-50).
            self.bodies[0].force = (self.bodies[0].force + jtl[0:3]).astype(F32)
            self.bodies[0].torque = (self.bodies[0].torque + jtl[3:6]).astype(F32)
        for b in self.bodies:
            b.step(dt)


def demo_scene() -> OracleScene:
    """reference: src/lib.rs:20-42."""
    body = OracleBody()
    body.position = np.array([1.0, 0.0, 0.0], F32)
    body.rotation = quat_from_euler(1.0, 0.0, 0.0)
    return OracleScene(
        bodies=[body],
        constraints=[
            OracleFixToPoint(0, np.zeros(3, F32)),
            OracleFixedOrientation(0, np.zeros(3, F32)),
        ],
    )
