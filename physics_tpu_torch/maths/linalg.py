"""Batched 3×3 helpers (physics_tpu/maths/linalg.py): nalgebra's
adjugate inverse, which the compat integrator applies to the body-frame
inertia every step, and the cross-product matrix of the joint rows."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def inv3x3(m: Tensor) -> Tensor:
    """Inverse of [..., 3, 3] matrices by adjugate over determinant, with
    nalgebra's cofactor order; no guard for a singular matrix (inf/nan)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    r0 = torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1)
    r1 = torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1)
    r2 = torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1)
    adj = torch.stack([r0, r1, r2], dim=-2)
    return adj * inv_det[..., None, None]


def skew(v: Tensor) -> Tensor:
    """[..., 3, 3] with skew(v) @ u = v × u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    r0 = torch.stack([zero, -z, y], dim=-1)
    r1 = torch.stack([z, zero, -x], dim=-1)
    r2 = torch.stack([-y, x, zero], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)
