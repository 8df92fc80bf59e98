"""Component-form 3-vector and 3x3 math (a "v3" is a tuple of three
same-shaped tensors, a matrix a row-major 9-tuple) and the quaternion
functions [..., 4] (w, x, y, z) that the step uses: a frozen copy of the
port's maths/vec3c.py and of mul, normalize, to_matrix and exp_map of its
maths/quaternion.py (renamed qmul, qnormalize, qmatrix, qexp)."""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
V3 = Tuple[Tensor, Tensor, Tensor]


def add(a, b) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(a, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def neg(a) -> V3:
    return (-a[0], -a[1], -a[2])


def dot(a, b) -> Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b) -> V3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def norm(a) -> Tensor:
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def where(mask, a, b) -> V3:
    return (
        torch.where(mask, a[0], b[0]),
        torch.where(mask, a[1], b[1]),
        torch.where(mask, a[2], b[2]),
    )


def mat_unpack(m: Tensor) -> tuple:
    """[.., 3, 3] → row-major 9-tuple."""
    return tuple(m[..., i, j] for i in range(3) for j in range(3))


def mat_vec(m: tuple, v) -> V3:
    return (
        m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
        m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
        m[6] * v[0] + m[7] * v[1] + m[8] * v[2],
    )


def quat_to_mat(q: Tensor) -> tuple:
    """Quaternion [.., 4] (w, x, y, z) → row-major 9-tuple, nalgebra's
    ww+xx−yy−zz expansion (maths.quaternion.to_matrix in component form)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    xy = x * y * 2.0
    wz = w * z * 2.0
    wy = w * y * 2.0
    xz = x * z * 2.0
    yz = y * z * 2.0
    wx = w * x * 2.0
    return (
        ww + xx - yy - zz, xy - wz, wy + xz,
        wz + xy, ww - xx + yy - zz, yz - wx,
        xz - wy, wx + yz, ww - xx - yy + zz,
    )


def sandwich(r: tuple, m: tuple) -> tuple:
    """R · M · Rᵀ for row-major 9-tuples (world-frame inertia)."""
    t = [
        sum(r[3 * i + k] * m[3 * k + j] for k in range(3))
        for i in range(3) for j in range(3)
    ]
    return tuple(
        sum(t[3 * i + k] * r[3 * j + k] for k in range(3))
        for i in range(3) for j in range(3)
    )


def qmul(q1: Tensor, q2: Tensor) -> Tensor:
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


def qnormalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(n, min=eps)


def qmatrix(q: Tensor) -> Tensor:
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


def qexp(v: Tensor) -> Tensor:
    """Unit quaternion from a rotation vector (exact identity at 0)."""
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    nonzero = n > 0.0
    safe_n = torch.where(nonzero, n, torch.ones_like(n))
    half = n * 0.5
    q = torch.cat([torch.cos(half), v * (torch.sin(half) / safe_n)], dim=-1)
    iden = torch.zeros_like(q)
    iden[..., 0] = 1.0
    return torch.where(nonzero, q, iden)
