"""Joint rows and the matrix-free operators of the joint solve
(physics_tpu/solver/joints.py).

Each joint slot holds dense 3×6 Jacobian blocks for its two bodies
(fixed capacity, masked rows): J·x gathers x at the slots' bodies and
contracts the blocks; Jᵀ·λ contracts per slot and adds onto the bodies
(index_add_). All four joint types are computed for every slot and the
result is selected by type. The contractions sum their terms in a fixed
order, left to right, as csrc/joint_cg.cu does inside the CG.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physics_tpu_torch.maths import quaternion as quat
from physics_tpu_torch.maths.linalg import skew
from physics_tpu_torch.state import (
    JOINT_BALL,
    JOINT_DISTANCE,
    JOINT_FIX_ORIENTATION,
    JOINT_FIX_POINT,
    JOINT_NONE,
    MAX_JOINT_ROWS,
    SimState,
)

Tensor = torch.Tensor


class JointRows(NamedTuple):
    """Dense, fixed-capacity constraint rows, R = J slots × 3."""

    c: Tensor        # [J, 3] constraint values
    j_a: Tensor      # [J, 3, 6] Jacobian block of body_a
    j_b: Tensor      # [J, 3, 6] Jacobian block of body_b
    jd_a: Tensor     # [J, 3, 6] J̇ block of body_a
    jd_b: Tensor     # [J, 3, 6] J̇ block of body_b
    ks: Tensor       # [J, 3]
    kd: Tensor       # [J, 3]
    rowmask: Tensor  # [J, 3] 1.0 for live rows
    body_a: Tensor   # [J] int64 (clamped to a body)
    body_b: Tensor   # [J] int64 (clamped; masked by has_b)
    has_b: Tensor    # [J] f32 1.0 if body_b takes part


def _lin_block(m3: Tensor) -> Tensor:
    return torch.cat([m3, torch.zeros_like(m3)], dim=-1)


def _ang_block(m3: Tensor) -> Tensor:
    return torch.cat([torch.zeros_like(m3), m3], dim=-1)


def _pick(t: Tensor, cases, other: Tensor) -> Tensor:
    """The value of the first (type, value) case whose type is t, else
    `other` (nested where, as the JAX package selects)."""
    out = other
    for jt, val in reversed(cases):
        out = torch.where(t == jt, val, out)
    return out


def joint_rows(state: SimState) -> JointRows:
    """The rows of every joint slot:
    FIX_POINT C = x_a − target, J_a = [I | 0];
    FIX_ORIENTATION C = euler(q_a) − target, J_a = [0 | I];
    BALL world anchors p = x + R r, C = p_a − p_b, J_a = [I | −skew(R_a r_a)],
    J_b = [−I | skew(R_b r_b)], J̇ from the rotating anchor arms;
    DISTANCE one row along n = d/‖d‖, C = ‖d‖ − L.
    Dead rows (NONE slots, DISTANCE's rows 1-2, body b without has_b) are
    zeroed so they drop out of every product."""
    js = state.joints
    jn = js.capacity
    n = state.num_bodies
    dev = state.device
    f32 = torch.float32
    a_idx = torch.clamp(js.body_a, 0, n - 1).long()
    b_idx = torch.clamp(js.body_b, 0, n - 1).long()
    pos_a, pos_b = state.pos[a_idx], state.pos[b_idx]
    quat_a, quat_b = state.quat[a_idx], state.quat[b_idx]
    om_a, om_b = state.omega[a_idx], state.omega[b_idx]
    eye = torch.eye(3, dtype=f32, device=dev).expand(jn, 3, 3)
    zeros36 = torch.zeros((jn, 3, 6), dtype=f32, device=dev)

    c_fp = pos_a - js.params[:, 0:3]
    ja_fp = _lin_block(eye)
    c_fo = quat.to_euler(quat_a) - js.params[:, 0:3]
    ja_fo = _ang_block(eye)

    ra_w = quat.rotate(quat_a, js.params[:, 0:3])
    rb_w = quat.rotate(quat_b, js.params[:, 3:6])
    anchor_a = pos_a + ra_w
    anchor_b = pos_b + rb_w
    c_ball = anchor_a - anchor_b
    ja_ball = torch.cat([eye, -skew(ra_w)], dim=-1)
    jb_ball = torch.cat([-eye, skew(rb_w)], dim=-1)
    jda_ball = _ang_block(-skew(torch.cross(om_a, ra_w, dim=-1)))
    jdb_ball = _ang_block(skew(torch.cross(om_b, rb_w, dim=-1)))

    d = anchor_b - anchor_a
    dist = torch.linalg.vector_norm(d, dim=-1)
    ndir = d / torch.clamp(dist, min=1e-9)[:, None]
    c_dist_row = dist - js.params[:, 6]
    z1 = torch.zeros_like(c_dist_row)
    c_dist = torch.stack([c_dist_row, z1, z1], dim=-1)
    ja_d_row = torch.cat([-ndir, -torch.cross(ra_w, ndir, dim=-1)], dim=-1)
    jb_d_row = torch.cat([ndir, torch.cross(rb_w, ndir, dim=-1)], dim=-1)
    z26 = torch.zeros((jn, 2, 6), dtype=f32, device=dev)
    ja_dist = torch.cat([ja_d_row[:, None, :], z26], dim=1)
    jb_dist = torch.cat([jb_d_row[:, None, :], z26], dim=1)

    t = js.jtype[:, None]
    zc = torch.zeros_like(c_fp)
    c = _pick(t, [(JOINT_FIX_POINT, c_fp), (JOINT_FIX_ORIENTATION, c_fo),
                  (JOINT_BALL, c_ball), (JOINT_DISTANCE, c_dist)], zc)
    t6 = js.jtype[:, None, None]
    j_a = _pick(t6, [(JOINT_FIX_POINT, ja_fp), (JOINT_FIX_ORIENTATION, ja_fo),
                     (JOINT_BALL, ja_ball), (JOINT_DISTANCE, ja_dist)],
                zeros36)
    j_b = _pick(t6, [(JOINT_BALL, jb_ball), (JOINT_DISTANCE, jb_dist)],
                zeros36)
    jd_a = torch.where(t6 == JOINT_BALL, jda_ball, zeros36)
    jd_b = torch.where(t6 == JOINT_BALL, jdb_ball, zeros36)

    nrows = torch.where(js.jtype == JOINT_NONE, 0,
                        torch.where(js.jtype == JOINT_DISTANCE, 1, 3))
    rowmask = (torch.arange(MAX_JOINT_ROWS, device=dev)[None, :]
               < nrows[:, None]).to(f32)
    has_b = ((js.body_b >= 0) & ((js.jtype == JOINT_BALL)
                                 | (js.jtype == JOINT_DISTANCE))).to(f32)
    mask_b = rowmask * has_b[:, None]
    return JointRows(
        c=c * rowmask,
        j_a=j_a * rowmask[:, :, None],
        j_b=j_b * mask_b[:, :, None],
        jd_a=jd_a * rowmask[:, :, None],
        jd_b=jd_b * mask_b[:, :, None],
        ks=js.ks[:, None] * rowmask,
        kd=js.kd[:, None] * rowmask,
        rowmask=rowmask, body_a=a_idx, body_b=b_idx, has_b=has_b)


def _rows_dot(blk: Tensor, x: Tensor) -> Tensor:
    """[J, 3, 6] blocks against [J, 6] vectors → [J, 3], each row's six
    products summed left to right."""
    y = blk[..., 0] * x[:, None, 0]
    for k in range(1, 6):
        y = y + blk[..., k] * x[:, None, k]
    return y


def _cols_dot(blk: Tensor, lam: Tensor) -> Tensor:
    """Jᵀ of one side: [J, 3, 6] blocks against [J, 3] → [J, 6],
    (j₀·λ₀ + j₁·λ₁) + j₂·λ₂."""
    return (blk[:, 0] * lam[:, 0:1] + blk[:, 1] * lam[:, 1:2]) \
        + blk[:, 2] * lam[:, 2:3]


def j_matvec(rows: JointRows, x: Tensor) -> Tensor:
    """y = J·x, x [N, 6] generalised vectors → y [J·3]."""
    y = _rows_dot(rows.j_a, x[rows.body_a]) + _rows_dot(rows.j_b,
                                                        x[rows.body_b])
    return y.reshape(-1)


def jd_matvec(rows: JointRows, x: Tensor) -> Tensor:
    """y = J̇·x (the layout of j_matvec)."""
    y = _rows_dot(rows.jd_a, x[rows.body_a]) + _rows_dot(rows.jd_b,
                                                         x[rows.body_b])
    return y.reshape(-1)


def jt_matvec(rows: JointRows, lam: Tensor, num_bodies: int) -> Tensor:
    """out = Jᵀ·λ, λ [J·3] → [N, 6]: each slot's 6-vectors added onto its
    bodies (body_a's, then body_b's)."""
    lam_r = lam.reshape(-1, MAX_JOINT_ROWS)
    out = torch.zeros((num_bodies, 6), dtype=torch.float32,
                      device=lam.device)
    out.index_add_(0, rows.body_a, _cols_dot(rows.j_a, lam_r))
    out.index_add_(0, rows.body_b, _cols_dot(rows.j_b, lam_r))
    return out


def apply_w(w: Tensor, x: Tensor) -> Tensor:
    """W·x for each body: w [N, 10] is a linear scale, then a 3×3 angular
    block (row-major); x [N, 6]. Each angular row (m₀·x₃ + m₁·x₄) + m₂·x₅."""
    lin = x[:, :3] * w[:, 0:1]
    ang = [(w[:, 1 + 3 * i] * x[:, 3] + w[:, 2 + 3 * i] * x[:, 4])
           + w[:, 3 + 3 * i] * x[:, 5] for i in range(3)]
    return torch.cat([lin, torch.stack(ang, dim=1)], dim=1)


def operator(rows: JointRows, w: Tensor, num_bodies: int):
    """λ ↦ J·W·Jᵀλ, the CG's matrix-free operator."""
    def apply(lam: Tensor) -> Tensor:
        return j_matvec(rows, apply_w(w, jt_matvec(rows, lam, num_bodies)))
    return apply
