"""Batched box-box SAT manifolds in component form, plain PyTorch: a
frozen copy of the port's ops/boxbox_batched.py.

SAT over 15 axes with ODE's face-preference fudge, reference-face
Sutherland–Hodgman clipping of the incident face (≤ 8 points), and the
edge-edge closest point. Every scalar is a tensor over the pair axis.
This is the narrow phase of the contact table's plain version
(reference/table.py).

Ties resolve to the LOWEST index (strict `>` in `_argmax_unrolled`), as
in the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from portbench.reference import vec as v3

Tensor = torch.Tensor

_CAP = 8
_FUDGE = 1.05
_PARALLEL_EPS = 1e-6


class Manifold(NamedTuple):
    points: List          # CAP × v3, world
    normal: Tuple         # v3 — B → A
    depth: List           # CAP × [P]
    valid: List           # CAP × [P] bool


def _axis_cols(r9):
    return [
        (r9[0], r9[3], r9[6]),
        (r9[1], r9[4], r9[7]),
        (r9[2], r9[5], r9[8]),
    ]


def _argmax_unrolled(vals):
    """(best, idx) over a static list; ties keep the lowest index."""
    best = vals[0]
    idx = torch.zeros_like(vals[0], dtype=torch.int32)
    for k in range(1, len(vals)):
        take = vals[k] > best
        best = torch.where(take, vals[k], best)
        idx = torch.where(take, torch.full_like(idx, k), idx)
    return best, idx


def _select(idx, items):
    """items[idx] for a static list of tensors / v3 tuples."""
    if isinstance(items[0], tuple):
        out = items[0]
        for k in range(1, len(items)):
            out = v3.where(idx == k, items[k], out)
        return out
    out = items[0]
    for k in range(1, len(items)):
        out = torch.where(idx == k, items[k], out)
    return out


def _sign(x: Tensor) -> Tensor:
    return torch.sign(x + 1e-30)


def _clip(pu, pv, ps, m, cu, cv, d):
    """One Sutherland–Hodgman half-plane clip of the [CAP, P] polygon
    (keep cu·u + cv·v ≤ d); m [P] int32 live count (any batch shape P)."""
    cap = pu.shape[0]
    slots = torch.arange(cap, dtype=torch.int32, device=pu.device).reshape(
        cap, *([1] * m.dim()))
    g = cu * pu + cv * pv - d[None]
    live = slots < m[None]
    wrap = (slots + 1) == m[None]

    def nxt(x):
        return torch.where(wrap, x[0][None], torch.roll(x, -1, dims=0))

    g_nxt = nxt(g)
    u_nxt, v_nxt, s_nxt = nxt(pu), nxt(pv), nxt(ps)
    inside = (g <= 0.0) & live
    crossing = ((g <= 0.0) != (g_nxt <= 0.0)) & live
    denom = g - g_nxt
    t = torch.where(torch.abs(denom) > 1e-12, g / denom,
                    torch.zeros_like(g))
    iu = pu + t * (u_nxt - pu)
    iv = pv + t * (v_nxt - pv)
    is_ = ps + t * (s_nxt - ps)

    inside_i = inside.to(torch.int32)
    emit = inside_i + crossing.to(torch.int32)
    start = torch.cumsum(emit, dim=0) - emit           # exclusive prefix
    pos_cur = torch.where(inside, start, torch.full_like(start, cap))
    pos_int = torch.where(crossing, start + inside_i,
                          torch.full_like(start, cap))
    # output slot j takes the one input placed there (slot i's point where
    # it is inside, its edge's intersection where that crosses) as 0 + x,
    # the value of the one-hot sum over the inputs; places from cap on are
    # dropped (row cap collects them)
    out = torch.zeros((3, cap + 1) + tuple(pu.shape[1:]), dtype=pu.dtype,
                      device=pu.device)
    for pos, src in ((pos_cur, (pu, pv, ps)), (pos_int, (iu, iv, is_))):
        idx = torch.clamp(pos, max=cap).to(torch.int64)
        out.scatter_(1, idx[None].expand(3, *idx.shape), torch.stack(src))
    ou, ov, os_ = out[:, :cap] + 0.0
    new_m = torch.clamp(torch.sum(emit, dim=0), max=cap).to(torch.int32)
    return ou, ov, os_, new_m


def box_box_manifold_batched(pa, ra9, ha, pb, rb9, hb) -> Manifold:
    """SAT + clipping manifolds for a batch of box pairs. pa/pb: v3
    positions; ra9/rb9: row-major world rotations; ha/hb: v3 half
    extents. The normal points B → A."""
    t_w = v3.sub(pb, pa)
    u = _axis_cols(ra9)
    w = _axis_cols(rb9)

    axes = list(u) + list(w)
    cross_axes, cross_ok = [], []
    for i in range(3):
        for j in range(3):
            cx = v3.cross(u[i], w[j])
            nn = v3.norm(cx)
            ok = nn > _PARALLEL_EPS
            inv = 1.0 / torch.clamp(nn, min=_PARALLEL_EPS)
            cross_axes.append(v3.scale(cx, inv))
            cross_ok.append(ok)
    axes = axes + cross_axes

    def proj(axis, half, cols):
        return (half[0] * torch.abs(v3.dot(axis, cols[0]))
                + half[1] * torch.abs(v3.dot(axis, cols[1]))
                + half[2] * torch.abs(v3.dot(axis, cols[2])))

    dist = [v3.dot(ax, t_w) for ax in axes]
    sep = []
    for k in range(15):
        s = torch.abs(dist[k]) - (proj(axes[k], ha, u)
                                  + proj(axes[k], hb, w))
        if k >= 6:
            s = torch.where(cross_ok[k - 6], s,
                            torch.full_like(s, -float("inf")))
        sep.append(s)

    separated = _argmax_unrolled(sep)[0] > 0.0
    best_face_sep, best_face = _argmax_unrolled(sep[:6])
    best_edge_sep, best_edge = _argmax_unrolled(sep[6:])
    any_edge = torch.zeros_like(best_face_sep, dtype=torch.bool)
    for ok in cross_ok:
        any_edge = any_edge | ok
    best_edge_sep = torch.where(any_edge, best_edge_sep,
                                torch.full_like(best_edge_sep,
                                                -float("inf")))
    use_edge = best_edge_sep * _FUDGE > best_face_sep

    axis_f = _select(best_face, axes[:6])
    dist_f = _select(best_face, dist[:6])
    n_face = v3.scale(axis_f, _sign(dist_f))             # A → B
    axis_e = _select(best_edge, axes[6:])
    dist_e = _select(best_edge, dist[6:])
    n_edge = v3.scale(axis_e, _sign(dist_e))

    # ---- face-contact manifold ----
    ref_is_a = best_face < 3
    ref_axis = torch.where(ref_is_a, best_face, best_face - 3)
    ref_cols = [v3.where(ref_is_a, u[k], w[k]) for k in range(3)]
    inc_cols = [v3.where(ref_is_a, w[k], u[k]) for k in range(3)]
    ref_half = [torch.where(ref_is_a, ha[k], hb[k]) for k in range(3)]
    inc_half = [torch.where(ref_is_a, hb[k], ha[k]) for k in range(3)]
    ref_pos = v3.where(ref_is_a, pa, pb)
    inc_pos = v3.where(ref_is_a, pb, pa)
    ref_n = v3.where(ref_is_a, n_face, v3.neg(n_face))

    one_i = torch.ones_like(ref_axis)
    p_idx = torch.where(ref_axis == 0, one_i, 0 * one_i)
    q_idx = torch.where(ref_axis == 2, one_i, 2 * one_i)
    u_p = _select(p_idx, ref_cols)
    u_q = _select(q_idx, ref_cols)
    h_p = _select(p_idx, ref_half)
    h_q = _select(q_idx, ref_half)
    h_axis = _select(ref_axis, ref_half)
    c_ref = v3.add(ref_pos, v3.scale(ref_n, h_axis))

    align = [v3.dot(inc_cols[k], ref_n) for k in range(3)]
    _, inc_axis = _argmax_unrolled([torch.abs(x) for x in align])
    inc_align = _select(inc_axis, align)
    inc_sign = -_sign(inc_align)
    inc_n_axis = _select(inc_axis, inc_cols)
    inc_h = _select(inc_axis, inc_half)
    c_inc = v3.add(inc_pos, v3.scale(inc_n_axis, inc_sign * inc_h))
    ip_idx = torch.where(inc_axis == 0, one_i, 0 * one_i)
    iq_idx = torch.where(inc_axis == 2, one_i, 2 * one_i)
    w_p = v3.scale(_select(ip_idx, inc_cols), _select(ip_idx, inc_half))
    w_q = v3.scale(_select(iq_idx, inc_cols), _select(iq_idx, inc_half))

    signs = [(1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)]
    zero = torch.zeros_like(h_p)
    su, sv, ss = [zero] * _CAP, [zero] * _CAP, [zero] * _CAP
    for k, (sp, sq) in enumerate(signs):
        corner = v3.add(c_inc, v3.add(v3.scale(w_p, sp), v3.scale(w_q, sq)))
        rel = v3.sub(corner, c_ref)
        su[k] = v3.dot(rel, u_p)
        sv[k] = v3.dot(rel, u_q)
        ss[k] = v3.dot(rel, ref_n)
    m = torch.full_like(ref_axis, 4)
    pu, pv, ps = torch.stack(su), torch.stack(sv), torch.stack(ss)

    pu, pv, ps, m = _clip(pu, pv, ps, m, 1.0, 0.0, h_p)
    pu, pv, ps, m = _clip(pu, pv, ps, m, -1.0, 0.0, h_p)
    pu, pv, ps, m = _clip(pu, pv, ps, m, 0.0, 1.0, h_q)
    pu, pv, ps, m = _clip(pu, pv, ps, m, 0.0, -1.0, h_q)

    face_points, face_depth, face_valid = [], [], []
    for k in range(_CAP):
        pt = v3.add(
            c_ref,
            v3.add(
                v3.add(v3.scale(u_p, pu[k]), v3.scale(u_q, pv[k])),
                v3.scale(ref_n, ps[k]),
            ),
        )
        face_points.append(pt)
        face_depth.append(-ps[k])
        face_valid.append((k < m) & (-ps[k] > 0.0))

    # ---- edge-contact point ----
    ei = best_edge // 3
    ej = best_edge % 3
    ua = _select(ei, u)
    vb = _select(ej, w)
    p_a, p_b = pa, pb
    for k in range(3):
        sa = _sign(v3.dot(u[k], n_edge)) * (ei != k) * ha[k]
        p_a = v3.add(p_a, v3.scale(u[k], sa))
        sb = _sign(-v3.dot(w[k], n_edge)) * (ej != k) * hb[k]
        p_b = v3.add(p_b, v3.scale(w[k], sb))
    d_ab = v3.sub(p_b, p_a)
    c_uv = v3.dot(ua, vb)
    denom = 1.0 - c_uv * c_uv
    s_par = torch.where(
        torch.abs(denom) > 1e-9,
        (v3.dot(d_ab, ua) - c_uv * v3.dot(d_ab, vb)) / denom,
        torch.zeros_like(denom),
    )
    r_par = s_par * c_uv - v3.dot(d_ab, vb)
    q_a = v3.add(p_a, v3.scale(ua, s_par))
    q_b = v3.add(p_b, v3.scale(vb, r_par))
    edge_point = v3.scale(v3.add(q_a, q_b), 0.5)
    edge_depth = -_select(best_edge, sep[6:])

    # ---- combine ----
    points, depth, valid = [], [], []
    for k in range(_CAP):
        if k == 0:
            points.append(v3.where(use_edge, edge_point, face_points[k]))
            depth.append(torch.where(use_edge, edge_depth, face_depth[k]))
            valid.append(
                ((use_edge & (edge_depth > 0.0))
                 | (~use_edge & face_valid[k]))
                & ~separated)
        else:
            points.append(face_points[k])
            depth.append(torch.where(use_edge, torch.zeros_like(zero),
                                     face_depth[k]))
            valid.append(~use_edge & face_valid[k] & ~separated)

    n_out = v3.neg(v3.where(use_edge, n_edge, n_face))  # B → A
    return Manifold(points=points, normal=n_out, depth=depth, valid=valid)
