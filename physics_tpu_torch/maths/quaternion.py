"""Quaternion math on [..., 4] tensors, (w, x, y, z) — the functions of
physics_tpu/maths/quaternion.py that the box-pile step calls, with the
same formulas and operation order."""

from __future__ import annotations

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
