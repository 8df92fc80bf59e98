"""Coefficient tables of the linear hull-hull SAT for one hull TYPE PAIR,
and the slot-major manifolds of the generic hull path built on them
(physics_tpu/ops/hullhull_batched.py: `HullTables`, `build_hull_tables`,
`_matT_vec`, `SharedManifoldSM`, `shared_hull_manifolds_sm`).

With hull A of type ia and hull B of type ib, every pairwise SAT quantity
is linear in the 9 components of the relative rotation M = R_aᵀ·R_b:

    face-A support   n_f·(M u)            =  (n_f ⊗ u)        : M
    face-B support   n_f·(Mᵀ v)           =  (v ⊗ n_f)        : M
    edge axis (A)    cross(d₁, M d₂)_i    =  (ε_ijk d₁_j d₂_l) : M
    A-vert on axis   cross(d₁, M d₂)·v    =  ((v×d₁) ⊗ d₂)    : M
    B-vert on axis   cross(Mᵀd₁, d₂)·v    =  (d₁ ⊗ (d₂×v))    : M
    face alignment   n_a·(M n_b)          =  (n_a ⊗ n_b)      : M

so each table row is 9 coefficients that the hull contact table
(ops/hull_table.py) dots with a pair's M. Every product here is an outer
product (the ε contraction has one non-zero term), so the tables are
exact in f32 whatever the evaluation order.

`shared_hull_manifolds_sm` takes every support of a batch of candidate
pairs as [rows, 9] × [9, P] matrix products against the relative
rotations, and every selection as a one-hot [rows, P] product, with the
pairs along the last axis. The products are plain matmuls, as in the
JAX package, in full f32: SAT separations near 0 decide the contact
set, so a CUDA matmul under TF32 is refused (`_mm`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from physics_tpu_torch.maths import quaternion as quat
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops.boxbox_batched import _clip

Tensor = torch.Tensor

BIG = 1e30


class HullTables(NamedTuple):
    """Coefficient tables for one hull type pair (A, B); all shapes are
    the HullSet's shared padded capacities."""

    verts_a: Tensor      # [V, 3] hull-A local vertices
    verts_b: Tensor      # [V, 3] hull-B local vertices
    face_n_a: Tensor     # [F, 3]
    face_n_b: Tensor     # [F, 3]
    face_off_a: Tensor   # [F] (padding planes set to 0)
    face_off_b: Tensor   # [F]
    face_mask_a: Tensor  # [F] f32
    face_mask_b: Tensor  # [F] f32
    face_verts_a: Tensor  # [F, E] int32
    face_verts_b: Tensor  # [F, E] int32
    face_cnt_a: Tensor    # [F] int32
    face_cnt_b: Tensor    # [F] int32
    a_fv: Tensor       # [F·V, 9]  n_f(A) ⊗ u(B)
    b_fv: Tensor       # [F·V, 9]  v(A) ⊗ n_f(B)
    l_ax: Tensor       # [D²·3, 9] ε d(A) d(B)
    c_av: Tensor       # [D²·V, 9] (v(A)×d(A)) ⊗ d(B)
    c_bv: Tensor       # [D²·V, 9] d(A) ⊗ (d(B)×v(B))
    ff: Tensor         # [F·F, 9]  n(A) ⊗ n(B)
    ax_mask: Tensor    # [D²] f32  dmask(A) ⊗ dmask(B)
    edge_i0_a: Tensor  # [E2] int32 unique-edge endpoints (A's edge list)
    edge_i1_a: Tensor
    edge_mask_a: Tensor  # [E2] f32
    edge_i0_b: Tensor
    edge_i1_b: Tensor
    edge_mask_b: Tensor


def _levi_civita(device) -> Tensor:
    eps = torch.zeros((3, 3, 3), dtype=torch.float32, device=device)
    for (i, j, k, s) in [(0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
                         (0, 2, 1, -1.0), (1, 0, 2, -1.0), (2, 1, 0, -1.0)]:
        eps[i, j, k] = s
    return eps


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis, componentwise as jnp.cross."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def build_hull_tables(hulls, idx: int = 0, idx_b: int | None = None
                      ) -> HullTables:
    """Coefficient tables for hull type pair (idx, idx_b) of a HullSet;
    idx_b=None ⇒ the shared-hull case (B = A)."""
    if idx_b is None:
        idx_b = idx
    dev = hulls.verts.device

    def side(i):
        v = hulls.verts[i]                                 # [V, 3]
        nf = hulls.face_normals[i]                         # [F, 3]
        off = hulls.face_offsets[i]                        # [F]
        fmask = torch.isfinite(off).to(torch.float32)
        # the 1e30 padding planes are finite in f32; as in the JAX
        # package they stay in the offsets and only ±inf is masked
        off = torch.where(fmask > 0, off, torch.zeros_like(off))
        d = hulls.edge_dirs[i]                             # [D, 3]
        dmask = (torch.arange(d.shape[0], device=dev)
                 < hulls.edge_dir_count[i]).to(torch.float32)
        emask = (torch.arange(hulls.edge_i0.shape[1], device=dev)
                 < hulls.edge_count[i]).to(torch.float32)
        return v, nf, off, fmask, d, dmask, emask

    va, nfa, offa, fmaska, da, dmaska, emaska = side(idx)
    vb, nfb, offb, fmaskb, db, dmaskb, emaskb = side(idx_b)

    f, vc, dc = nfa.shape[0], va.shape[0], da.shape[0]
    eps = _levi_civita(dev)
    a_fv = torch.einsum("fk,ul->fukl", nfa, vb).reshape(f * vc, 9)
    b_fv = torch.einsum("uk,fl->fukl", va, nfb).reshape(f * vc, 9)
    l_ax = torch.einsum("ijk,aj,bl->abikl", eps, da, db).reshape(
        dc * dc * 3, 9)
    vxd = _cross(va[None, :, :], da[:, None, :])      # [D, V, 3] v_u × d_a
    c_av = torch.einsum("auk,bl->abukl", vxd, db).reshape(dc * dc * vc, 9)
    dxv = _cross(db[:, None, :], vb[None, :, :])      # [D, V, 3] d_b × v_u
    c_bv = torch.einsum("ak,bul->abukl", da, dxv).reshape(dc * dc * vc, 9)
    ff = torch.einsum("ak,bl->abkl", nfa, nfb).reshape(f * f, 9)
    ax_mask = (dmaska[:, None] * dmaskb[None, :]).reshape(-1)

    return HullTables(
        verts_a=va, verts_b=vb,
        face_n_a=nfa, face_n_b=nfb,
        face_off_a=offa, face_off_b=offb,
        face_mask_a=fmaska, face_mask_b=fmaskb,
        face_verts_a=hulls.face_verts[idx],
        face_verts_b=hulls.face_verts[idx_b],
        face_cnt_a=hulls.face_vert_count[idx],
        face_cnt_b=hulls.face_vert_count[idx_b],
        a_fv=a_fv, b_fv=b_fv, l_ax=l_ax, c_av=c_av, c_bv=c_bv, ff=ff,
        ax_mask=ax_mask,
        edge_i0_a=hulls.edge_i0[idx], edge_i1_a=hulls.edge_i1[idx],
        edge_mask_a=emaska,
        edge_i0_b=hulls.edge_i0[idx_b], edge_i1_b=hulls.edge_i1[idx_b],
        edge_mask_b=emaskb,
    )


def hull_tables(hulls, ia: int = 0, ib: int | None = None) -> HullTables:
    """build_hull_tables of type pair (ia, ib), kept on the HullSet
    (HullSet.derived): built once a library, rebuilt if it changes. The
    generic hull path's manifolds and the hull table's coefficients
    (ops/hull_table.build_hull_coef) get their tables here."""
    ib = ia if ib is None else ib
    return hulls.derived(("hull_tables", ia, ib),
                         lambda: build_hull_tables(hulls, ia, ib))


def _tf32_matmul() -> bool:
    p = torch.backends.cuda.matmul.fp32_precision
    if p == "none":
        p = torch.backends.fp32_precision
    return p == "tf32"


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """a @ b in full f32; on a CUDA tensor while TF32 matmuls are enabled
    it raises rather than round the supports to TF32."""
    if b.is_cuda and _tf32_matmul():
        raise RuntimeError(
            "the hull SAT's support products need full-f32 matmuls: set "
            "torch.backends.cuda.matmul.fp32_precision = 'ieee' (or "
            "allow_tf32 = False)")
    return a @ b


def _matT_vec(m: tuple, w) -> tuple:
    """Mᵀ·w for a row-major 9-tuple."""
    return (
        m[0] * w[0] + m[3] * w[1] + m[6] * w[2],
        m[1] * w[0] + m[4] * w[1] + m[7] * w[2],
        m[2] * w[0] + m[5] * w[1] + m[8] * w[2],
    )


class SharedManifoldSM(NamedTuple):
    """Slot-major manifold pieces of P candidate pairs: [P] lane rows, v3
    tuples of them, or [2E, P] tensors (S = 2E + 1 slots: 0..2E−1 the
    clipped face manifold, 2E the edge contact).

    World point of face slot s = p0 + pu[s]·t1 + pv[s]·t2 + ps[s]·n_ref;
    its normal is n_face. `depth` rows are already validity-masked
    (> 0 ⇔ an active contact candidate)."""

    depth: Tuple      # S × [P]
    pu: Tensor        # [2E, P] clipped polygon coords in the ref-face frame
    pv: Tensor        # [2E, P]
    ps: Tensor        # [2E, P] signed separation along n_ref
    p0: Tuple         # v3 — ref-face frame origin
    t1: Tuple         # v3 — ref-face tangent
    t2: Tuple         # v3 — ref-face bitangent
    n_ref: Tuple      # v3 — world ref-face normal (ref → incident)
    n_face: Tuple     # v3 — world face-contact normal, B → A
    edge_point: Tuple  # v3 — edge-contact world point
    n_edge: Tuple     # v3 — world edge-contact normal, B → A


def shared_hull_manifolds_sm(state, cand, types: Tuple[int, int] = (0, 0),
                             with_separated: bool = False):
    """Slot-major manifolds of every candidate pair of one hull TYPE PAIR
    (endpoint a of type types[0], b of types[1]): the face and edge SAT
    from the coefficient tables, the reference face (ties to the lowest
    index), the most anti-parallel incident face, its polygon clipped
    against the reference face's edges, and the closest points of the
    best edge pair. `with_separated`: (manifolds, [P] bool: the SAT found
    a separating axis)."""
    ht = hull_tables(state.hulls, *types)
    ia, ib = cand.body_a.long(), cand.body_b.long()
    p = ia.shape[0]
    dev = state.pos.device
    f = ht.face_n_a.shape[0]
    vc = ht.verts_a.shape[0]
    d2 = ht.ax_mask.shape[0]
    e_cap = ht.face_verts_a.shape[1]
    cap = 2 * e_cap
    f32 = torch.float32

    qa = state.quat[ia]
    qb = state.quat[ib]
    qa_c = torch.stack([qa[:, 0], -qa[:, 1], -qa[:, 2], -qa[:, 3]], dim=-1)
    m9 = v3.quat_to_mat(quat.mul(qa_c, qb))                # 9 × [P]
    ra9 = v3.quat_to_mat(qa)
    rb9 = v3.quat_to_mat(qb)
    pa = (state.pos[ia, 0], state.pos[ia, 1], state.pos[ia, 2])
    pb = (state.pos[ib, 0], state.pos[ib, 1], state.pos[ib, 2])
    dp = v3.sub(pb, pa)                                    # p_b − p_a
    dpa = _matT_vec(ra9, dp)                               # R_aᵀ(p_b−p_a)
    dpb = _matT_vec(rb9, v3.neg(dp))                       # R_bᵀ(p_a−p_b)
    m_mat = torch.stack(m9)                                # [9, P]
    dpa_m = torch.stack(dpa)                               # [3, P]
    dpb_m = torch.stack(dpb)

    # ---- every support in a few [rows, 9] × [9, P] products ----
    neg_big = torch.full((), -BIG, dtype=f32, device=dev)
    sa = _mm(ht.a_fv, m_mat).reshape(f, vc, p)
    sep_a = (torch.amin(sa, dim=1) + _mm(ht.face_n_a, dpa_m)
             - ht.face_off_a[:, None])
    sep_a = torch.where(ht.face_mask_a[:, None] > 0, sep_a, neg_big)
    sb = _mm(ht.b_fv, m_mat).reshape(f, vc, p)
    sep_b = (torch.amin(sb, dim=1) + _mm(ht.face_n_b, dpb_m)
             - ht.face_off_b[:, None])
    sep_b = torch.where(ht.face_mask_b[:, None] > 0, sep_b, neg_big)

    s_av = _mm(ht.c_av, m_mat).reshape(d2, vc, p)
    min_a_e = torch.amin(s_av, dim=1)
    max_a_e = torch.amax(s_av, dim=1)                      # [D², P]
    s_bv = _mm(ht.c_bv, m_mat).reshape(d2, vc, p)
    min_b_e = torch.amin(s_bv, dim=1)
    max_b_e = torch.amax(s_bv, dim=1)
    axes = _mm(ht.l_ax, m_mat).reshape(d2, 3, p)
    ax2 = torch.sum(axes * axes, dim=1)                    # [D², P]
    alen = torch.sqrt(torch.clamp(ax2, min=1e-18))
    t_ax = -torch.sum(axes * dpa_m[None], dim=1)           # ax·(p_a−p_b)
    flip = t_ax < 0.0
    sep_num = torch.where(flip, min_b_e - max_a_e - t_ax,
                          min_a_e - max_b_e + t_ax)
    ax_ok = (ht.ax_mask[:, None] > 0) & (alen > 1e-6)
    sep_e = torch.where(ax_ok, sep_num / alen, neg_big)    # [D², P]

    # ---- axis choice ----
    sep_faces = torch.cat([sep_a, sep_b], dim=0)           # [2F, P]
    face_sep, best_f = torch.amax(sep_faces, dim=0), torch.argmax(
        sep_faces, dim=0)
    edge_sep, best_e = torch.amax(sep_e, dim=0), torch.argmax(sep_e, dim=0)
    separated = torch.maximum(face_sep, edge_sep) > 0.0
    edge_wins = (~separated) & (
        edge_sep > face_sep + 1e-4 + 0.05 * torch.abs(face_sep))

    ref_is_a = best_f < f
    ref_idx = torch.where(ref_is_a, best_f, best_f - f)    # [P]
    f_iota = torch.arange(f, device=dev)[:, None]
    oh_ref = (f_iota == ref_idx[None, :]).to(f32)          # [F, P]

    # ---- incident face: the most anti-parallel face of the other hull ----
    big_col_a = torch.where(ht.face_mask_a > 0, 0.0, BIG)
    big_col_b = torch.where(ht.face_mask_b > 0, 0.0, BIG)
    ff3 = ht.ff.reshape(f, f, 9)

    def align_against_ref(c_tab):
        # c_tab [F_other, F_ref, 9], contracted over the ref axis
        ce = _mm(c_tab.permute(1, 0, 2).reshape(f, f * 9).T, oh_ref)
        return torch.sum(ce.reshape(f, 9, p) * m_mat[None], dim=1)

    al_b = align_against_ref(ff3.permute(1, 0, 2)) + big_col_b[:, None]
    al_a = align_against_ref(ff3) + big_col_a[:, None]
    inc_idx = torch.where(ref_is_a, torch.argmin(al_b, dim=0),
                          torch.argmin(al_a, dim=0))
    oh_inc = (f_iota == inc_idx[None, :]).to(f32)          # [F, P]

    # ---- owner frame → world polygons, component form ----
    r_ref = tuple(torch.where(ref_is_a, ra9[k], rb9[k]) for k in range(9))
    r_inc = tuple(torch.where(ref_is_a, rb9[k], ra9[k]) for k in range(9))
    p_ref = v3.where(ref_is_a, pa, pb)
    p_inc = v3.where(ref_is_a, pb, pa)

    same = types[0] == types[1]
    poly_a = ht.verts_a[ht.face_verts_a.long()]            # [F, E, 3]
    poly_b = poly_a if same else ht.verts_b[ht.face_verts_b.long()]

    def owner_sel(oh, tab_a, tab_b, ref_side):
        """The one-hot's rows of the owner's table ([E, 3, P]): A's where
        ref_side, else B's."""
        ea = _mm(tab_a.reshape(f, e_cap * 3).T, oh).reshape(e_cap, 3, p)
        if same:
            return ea
        eb = _mm(tab_b.reshape(f, e_cap * 3).T, oh).reshape(e_cap, 3, p)
        return torch.where(ref_side[None, None, :], ea, eb)

    ref_loc = owner_sel(oh_ref, poly_a, poly_b, ref_is_a)
    inc_loc = owner_sel(oh_inc, poly_a, poly_b, ~ref_is_a)

    def owner_row(oh, row_a, row_b, ref_side):
        ra_v = _mm(row_a[None], oh)[0]
        if same:
            return ra_v
        return torch.where(ref_side, ra_v, _mm(row_b[None], oh)[0])

    fcnt_a = ht.face_cnt_a.to(f32)
    fcnt_b = ht.face_cnt_b.to(f32)
    ref_cnt = torch.round(
        owner_row(oh_ref, fcnt_a, fcnt_b, ref_is_a)).to(torch.int32)
    inc_cnt = torch.round(
        owner_row(oh_inc, fcnt_a, fcnt_b, ~ref_is_a)).to(torch.int32)

    def to_world(loc, r, t):
        # loc [E, 3, P] in the owner's frame → E world v3
        return [(r[0] * loc[k, 0] + r[1] * loc[k, 1] + r[2] * loc[k, 2] + t[0],
                 r[3] * loc[k, 0] + r[4] * loc[k, 1] + r[5] * loc[k, 2] + t[1],
                 r[6] * loc[k, 0] + r[7] * loc[k, 1] + r[8] * loc[k, 2] + t[2])
                for k in range(loc.shape[0])]

    ref_w = to_world(ref_loc, r_ref, p_ref)
    inc_w = to_world(inc_loc, r_inc, p_inc)

    n_ref_loc = tuple(
        owner_row(oh_ref, ht.face_n_a[:, c].contiguous(),
                  ht.face_n_b[:, c].contiguous(), ref_is_a)
        for c in range(3))                                 # owner frame
    n_ref = v3.mat_vec(r_ref, n_ref_loc)                   # world, ref→inc
    off_ref = (owner_row(oh_ref, ht.face_off_a, ht.face_off_b, ref_is_a)
               + v3.dot(n_ref, p_ref))

    # ---- 2-D clip in the reference-face frame ----
    edge0 = v3.sub(ref_w[1], ref_w[0])
    t1 = v3.scale(edge0, 1.0 / torch.clamp(v3.norm(edge0), min=1e-9))
    t2 = v3.cross(n_ref, t1)
    p0 = ref_w[0]

    ru, rv = [], []
    for k in range(e_cap):
        rel = v3.sub(ref_w[k], p0)
        ru.append(v3.dot(rel, t1))
        rv.append(v3.dot(rel, t2))
    iu_l, iv_l, is_l = [], [], []
    for k in range(e_cap):
        q = inc_w[k]
        rel = v3.sub(q, p0)
        iu_l.append(v3.dot(rel, t1))
        iv_l.append(v3.dot(rel, t2))
        is_l.append(v3.dot(q, n_ref) - off_ref)
    pad = [torch.zeros((p,), dtype=f32, device=dev)] * e_cap
    pu = torch.stack(iu_l + pad)                           # [CAP, P]
    pv = torch.stack(iv_l + pad)
    ps = torch.stack(is_l + pad)
    m_cnt = inc_cnt

    for k in range(e_cap):
        # ref edge k → k+1 (wrapping to 0 at ref_cnt); a no-op past it
        if k + 1 < e_cap:
            wrapped = (k + 1) == ref_cnt
            ru_n = torch.where(wrapped, ru[0], ru[k + 1])
            rv_n = torch.where(wrapped, rv[0], rv[k + 1])
        else:
            ru_n, rv_n = ru[0], rv[0]
        e_u = ru_n - ru[k]
        e_v = rv_n - rv[k]
        on = (k < ref_cnt).to(f32)
        cu = e_v * on
        cv = -e_u * on
        d = (e_v * ru[k] - e_u * rv[k]) * on + (1.0 - on) * 1e30
        pu, pv, ps, m_cnt = _clip(pu, pv, ps, m_cnt, cu, cv, d)

    n_face = v3.where(ref_is_a, v3.neg(n_ref), n_ref)      # B → A

    # ---- edge-edge closest-point contact ----
    d2_iota = torch.arange(d2, device=dev)[:, None]
    oh_e = (d2_iota == best_e[None, :]).to(f32)            # [D², P]
    ax_sel = tuple(torch.sum(oh_e * axes[:, c, :], dim=0) for c in range(3))
    alen_sel = torch.sum(oh_e * alen, dim=0)
    flip_sel = torch.sum(oh_e * flip.to(f32), dim=0) > 0.5
    sgn = torch.where(flip_sel, -1.0, 1.0)
    ax_u = v3.scale(ax_sel, sgn / torch.clamp(alen_sel, min=1e-9))
    n_edge = v3.mat_vec(ra9, ax_u)                         # world, B → A

    def sel_axis_supports(c_tab):
        # the one-hot contracted with the static table first ([V·9, P]),
        # then dotted with the 9 rotation components
        ce = _mm(c_tab.reshape(d2, vc * 9).T, oh_e)
        return torch.sum(ce.reshape(vc, 9, p) * m_mat[None], dim=1)

    sa_sel = sel_axis_supports(ht.c_av) * sgn[None, :]     # [V, P] A verts
    sb_sel = sel_axis_supports(ht.c_bv) * sgn[None, :]     # [V, P] B verts
    e2 = ht.edge_i0_a.shape[0]

    def one_hot(idx):
        # a compare, not F.one_hot, whose range check reads back on a GPU
        return (idx[:, None] == torch.arange(vc, device=dev)).to(f32)

    oh_i0a, oh_i1a = one_hot(ht.edge_i0_a), one_hot(ht.edge_i1_a)
    if same:
        oh_i0b, oh_i1b = oh_i0a, oh_i1a
    else:
        oh_i0b, oh_i1b = one_hot(ht.edge_i0_b), one_hot(ht.edge_i1_b)
    sa0 = _mm(oh_i0a, sa_sel)
    sa1 = _mm(oh_i1a, sa_sel)                              # [E2, P]
    sb0 = _mm(oh_i0b, sb_sel)
    sb1 = _mm(oh_i1b, sb_sel)
    edge_pad_a = torch.where(ht.edge_mask_a[:, None] > 0, 0.0, BIG)
    edge_pad_b = (edge_pad_a if same else
                  torch.where(ht.edge_mask_b[:, None] > 0, 0.0, BIG))
    score_a = torch.maximum(sa0, sa1) + edge_pad_a         # support along −n
    score_b = torch.minimum(sb0, sb1) - edge_pad_b         # support along +n
    ea_idx = torch.argmin(score_a, dim=0)                  # [P]
    eb_idx = torch.argmax(score_b, dim=0)
    e2_iota = torch.arange(e2, device=dev)[:, None]
    oh_ea = (e2_iota == ea_idx[None, :]).to(f32)           # [E2, P]
    oh_eb = (e2_iota == eb_idx[None, :]).to(f32)

    v0e_a = _mm(oh_i0a, ht.verts_a)                        # [E2, 3]
    v1e_a = _mm(oh_i1a, ht.verts_a)
    v0e_b = v0e_a if same else _mm(oh_i0b, ht.verts_b)
    v1e_b = v1e_a if same else _mm(oh_i1b, ht.verts_b)

    def esel(oh, ve):
        # the selected edge endpoint's [P] rows (owner frame)
        return tuple(_mm(ve[:, c].contiguous()[None], oh)[0]
                     for c in range(3))

    ea0 = v3.add(v3.mat_vec(ra9, esel(oh_ea, v0e_a)), pa)  # world
    ea1 = v3.add(v3.mat_vec(ra9, esel(oh_ea, v1e_a)), pa)
    eb0 = v3.add(v3.mat_vec(rb9, esel(oh_eb, v0e_b)), pb)
    eb1 = v3.add(v3.mat_vec(rb9, esel(oh_eb, v1e_b)), pb)

    d1 = v3.sub(ea1, ea0)
    d2v = v3.sub(eb1, eb0)
    r0 = v3.sub(ea0, eb0)
    a11 = v3.dot(d1, d1)
    a22 = v3.dot(d2v, d2v)
    a12 = v3.dot(d1, d2v)
    b1 = v3.dot(d1, r0)
    b2 = v3.dot(d2v, r0)
    den = a11 * a22 - a12 * a12
    zero = torch.zeros_like(den)
    s = torch.where(torch.abs(den) > 1e-9, (a12 * b2 - a22 * b1) / den, zero)
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(a22 > 1e-9, (b2 + a12 * s) / a22, zero)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.where(a11 > 1e-9, torch.clamp((a12 * t - b1) / a11, 0.0, 1.0),
                    s)
    pa_c = v3.add(ea0, v3.scale(d1, s))
    pb_c = v3.add(eb0, v3.scale(d2v, t))
    edge_point = v3.scale(v3.add(pa_c, pb_c), 0.5)
    edge_depth = -edge_sep

    # ---- slot-major depth rows, validity folded in ----
    face_ok = ~separated & ~edge_wins                      # [P]
    depth_rows = []
    for s_i in range(cap):
        d_row = -ps[s_i]
        ok = (s_i < m_cnt) & (d_row > 0.0) & face_ok
        depth_rows.append(torch.where(ok, d_row, zero))
    depth_rows.append(torch.where(edge_wins & (edge_depth > 0.0),
                                  edge_depth, zero))
    sm = SharedManifoldSM(
        depth=tuple(depth_rows), pu=pu, pv=pv, ps=ps,
        p0=p0, t1=t1, t2=t2, n_ref=n_ref, n_face=n_face,
        edge_point=edge_point, n_edge=n_edge)
    return (sm, separated) if with_separated else sm
