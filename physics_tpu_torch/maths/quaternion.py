"""Quaternion math on [..., 4] tensors, (w, x, y, z) — the functions of
physics_tpu/maths/quaternion.py that the port's steps call, with the
same formulas and operation order (nalgebra's conventions: the
ww+xx−yy−zz rotation matrix, roll-pitch-yaw euler angles with
R = Rz(yaw)·Ry(pitch)·Rx(roll), the exact identity of exp_map at 0)."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def mul(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product q1 ⊗ q2."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def rotate(q: Tensor, v: Tensor) -> Tensor:
    """v [..., 3] rotated by q: t = 2 q_v × v; v' = v + w t + q_v × t."""
    w = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * torch.cross(qv, v, dim=-1)
    return v + w * t + torch.cross(qv, t, dim=-1)


def from_euler(roll: Tensor, pitch: Tensor, yaw: Tensor) -> Tensor:
    """Quaternion from roll-pitch-yaw (R = Rz(yaw)·Ry(pitch)·Rx(roll))."""
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    sr, cr = torch.sin(hr), torch.cos(hr)
    sp, cp = torch.sin(hp), torch.cos(hp)
    sy, cy = torch.sin(hy), torch.cos(hy)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def to_euler(q: Tensor) -> Tensor:
    """Roll-pitch-yaw [..., 3] from q, nalgebra's euler_angles(): the main
    branch |R₂₀| < 1 and the two gimbal-lock branches, selected without
    control flow."""
    r = to_matrix(q)
    r20 = r[..., 2, 0]
    in_range = torch.abs(r20) < 1.0
    pitch_m = -torch.arcsin(torch.clamp(r20, -1.0, 1.0))
    cp = torch.cos(pitch_m)
    safe_cp = torch.where(in_range, cp, torch.ones_like(cp))
    roll_m = torch.atan2(r[..., 2, 1] / safe_cp, r[..., 2, 2] / safe_cp)
    yaw_m = torch.atan2(r[..., 1, 0] / safe_cp, r[..., 0, 0] / safe_cp)
    at_neg = r20 <= -1.0
    roll_g = torch.where(at_neg, torch.atan2(r[..., 0, 1], r[..., 0, 2]),
                         torch.atan2(-r[..., 0, 1], -r[..., 0, 2]))
    # ±π/2 rounded to f32, as the JAX package's astype gives them
    half_pi = torch.full_like(r20, math.pi / 2.0)
    pitch_g = torch.where(at_neg, half_pi, -half_pi)
    roll = torch.where(in_range, roll_m, roll_g)
    pitch = torch.where(in_range, pitch_m, pitch_g)
    yaw = torch.where(in_range, yaw_m, torch.zeros_like(yaw_m))
    return torch.stack([roll, pitch, yaw], dim=-1)


def normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(n, min=eps)


def to_matrix(q: Tensor) -> Tensor:
    """Rotation matrix [..., 3, 3], nalgebra's ww+xx−yy−zz expansion."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    xy = x * y * 2.0
    wz = w * z * 2.0
    wy = w * y * 2.0
    xz = x * z * 2.0
    yz = y * z * 2.0
    wx = w * x * 2.0
    r0 = torch.stack([ww + xx - yy - zz, xy - wz, wy + xz], dim=-1)
    r1 = torch.stack([wz + xy, ww - xx + yy - zz, yz - wx], dim=-1)
    r2 = torch.stack([xz - wy, wx + yz, ww - xx - yy + zz], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def exp_map(v: Tensor) -> Tensor:
    """Unit quaternion from a rotation vector (exact identity at 0)."""
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    nonzero = n > 0.0
    safe_n = torch.where(nonzero, n, torch.ones_like(n))
    half = n * 0.5
    q = torch.cat([torch.cos(half), v * (torch.sin(half) / safe_n)], dim=-1)
    iden = torch.zeros_like(q)
    iden[..., 0] = 1.0
    return torch.where(nonzero, q, iden)
