"""The contact list of the generic hull path, plain PyTorch: a frozen copy
of the port's hull_contact_list under rain_xla_config (solver/contacts.py
with banded_inputs and contact_capacity), cut to scenes whose every body
is a movable-or-static hull of a library of at most 4 types. From
ops/broadphase.py the flat sweep's [N·k] lanes and `compact_pairs`; from
ops/narrowphase.py the hull vertices on the ground, the OBB face-axis
prefilter and the slot-major pair contacts with their kk argmax picks;
from ops/hullhull_batched.py the slot-major manifolds of a type pair
(`manifolds_sm`: the linear SAT from the coefficient tables, the
reference and incident faces, the clip, the edge-edge point); from
ops/narrowphase_banded.py and solver/banded_solve.py the widths the
list and the solve share.

The masks of 2.1, the geometry table and the sweep order are
reference/table.py's and reference/hull_table.py's; the coefficient
tables are reference/hull_table.py's build_hull_tables.

Departures from the port: the coefficient tables are built again each
step (the port keeps them on its HullSet); every body is a hull, so the
shape-type tests (collidable, is_hull) read as true; the supports'
matmuls run in whatever the caller set (the reference's initial_state
turns TF32 off) rather than raising under TF32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from portbench.reference import vec as v3
from portbench.reference.boxbox import _argmax_unrolled, _clip, _select
from portbench.reference.hull_table import (
    build_hull_tables,
    hull_aabbs,
    hull_geom,
)
from portbench.reference.table import (
    PairCandidates,
    sweep_order,
    sweep_window_masks_plain,
)

Tensor = torch.Tensor

BIG = 1e30


class Contacts(NamedTuple):
    """Flat contact buffer. `normal` points from body_b toward body_a;
    body_b == -1 ⇒ the ground. Vector fields are [3, C]."""

    body_a: Tensor       # [C] int32
    body_b: Tensor       # [C] int32
    point: Tensor        # [3, C]
    normal: Tensor       # [3, C]
    depth: Tensor        # [C] (> 0 where active)
    active: Tensor       # [C] bool
    friction: Tensor     # [C]
    restitution: Tensor  # [C]
    key: Tensor          # [C] int32 (pairs ≥ 0, ground < 0, 0 inactive)


def concat_contacts(*groups: Contacts) -> Contacts:
    groups = [g for g in groups if g is not None and g.body_a.shape[0] > 0]
    if len(groups) == 1:
        return groups[0]
    return Contacts(*[
        torch.cat([getattr(g, f) for g in groups],
                  dim=1 if f in ("point", "normal") else 0)
        for f in Contacts._fields])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def solve_shape(n: int, c: int, cfg) -> Tuple[int, int, int]:
    """(tile, wtot, npad) of a solve of c contacts over n bodies; npad is
    the body table's width (narrowphase_banded.body_table_width)."""
    tile = min(cfg.pallas_tile, max(_round_up(c, 128), 128))
    wtot = cfg.pallas_window
    return tile, wtot, _round_up(max(n + wtot, wtot), 128)


def padded_contact_count(n: int, c: int, cfg) -> int:
    tile, _, _ = solve_shape(n, c, cfg)
    return _round_up(max(c, 1), tile)


def pair_lanes(n: int, cfg, n_hulls: int) -> int:
    """The lanes the pair contacts run on: the flat sweep's N·k compacted
    to max_pair_candidates, then the prefilter's cap2 (H > 1: H²
    segments of cap2 // H²)."""
    p = n * min(cfg.sweep_window, n - 1)
    if cfg.max_pair_candidates > 0:
        p = min(p, cfg.max_pair_candidates)
    if cfg.hull_prefilter_cap > 0:
        if n_hulls == 1:
            p = min(p, cfg.hull_prefilter_cap)
        else:
            n_seg = n_hulls * n_hulls
            p = n_seg * min(max(cfg.hull_prefilter_cap // n_seg, 1), p)
    return p


def contact_capacity(st, cfg) -> int:
    """The solve's contact slots: the hull vertices on the ground (k·N)
    and the slot-major pair slots (kk·P), capped at max_contacts and
    padded to the tile."""
    n = st.num_bodies
    hs = st.hulls
    n_slots = 2 * hs.face_verts.shape[2] + 1
    c = 0
    if cfg.ground_plane:
        c += min(cfg.max_contacts_per_pair, 8, hs.verts.shape[1]) * n
    if cfg.pair_collisions and n > 1:
        c += min(cfg.max_contacts_per_pair, n_slots) * pair_lanes(
            n, cfg, hs.verts.shape[0])
    if cfg.max_contacts > 0:
        c = min(c, cfg.max_contacts)
    return padded_contact_count(n, c, cfg)


def sweep_candidates(order: Tensor, aabbs: Tensor, k: int
                     ) -> PairCandidates:
    """The flat sweep's [N·k] lanes, rank-major: lane i·k + d − 1 tests
    sorted ranks (i, i + d), body_b 0 past the last rank, rank_b clamped
    to N − 1; overflow counts the ranks whose window may be too short."""
    n = order.shape[0]
    dev = order.device
    oi = order.long()
    mask, last = sweep_window_masks_plain(
        aabbs[oi].contiguous(),
        torch.ones((n,), dtype=torch.bool, device=dev), k)
    pad_order = torch.cat([order, order.new_zeros((k,))])
    nb_order = torch.stack([pad_order[d:d + n] for d in range(1, k + 1)],
                           dim=1)                            # [N, k]
    ranks = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    offs = torch.arange(1, k + 1, dtype=torch.int32, device=dev)[None, :]
    return PairCandidates(
        order[:, None].expand(n, k).reshape(-1), nb_order.reshape(-1),
        mask.reshape(-1), torch.sum(last.to(torch.int32)).to(torch.int32),
        ranks.expand(n, k).reshape(-1),
        torch.clamp(ranks + offs, max=n - 1).reshape(-1))


def compact_pairs(cand: PairCandidates, max_pairs: int) -> PairCandidates:
    """The first `max_pairs` hits in emission order, then the misses in
    theirs (a stable sort on the inverted mask); the hits dropped are
    added to `overflow`."""
    p = cand.body_a.shape[0]
    if max_pairs <= 0 or p <= max_pairs:
        return cand
    idx = torch.sort((~cand.mask).to(torch.uint8), stable=True)[1][:max_pairs]
    dropped = torch.clamp(torch.sum(cand.mask.to(torch.int32)) - max_pairs,
                          min=0)
    return PairCandidates(cand.body_a[idx], cand.body_b[idx], cand.mask[idx],
                          (cand.overflow + dropped).to(torch.int32),
                          cand.rank_a[idx], cand.rank_b[idx])


def ground_contacts(st, cfg) -> Contacts:
    """Hull vertices against y = ground_height, slot-major [k·N], k =
    min(max_contacts_per_pair, 8, V): the deepest k of each body by k
    argmax passes over its [V, N] heights (ties to the lowest vertex).
    Keys are −(body·V + vertex + 1)."""
    n = st.num_bodies
    dev = st.device
    hulls = st.hulls
    n_hulls = hulls.verts.shape[0]
    vcap = hulls.verts.shape[1]
    r9 = v3.quat_to_mat(st.quat)                           # 9 × [N]
    if n_hulls == 1:
        t_oh = None
    else:
        tidx = torch.clamp(st.shapes.hull_index, 0, n_hulls - 1)
        t_oh = [(tidx == t)[None, :].to(torch.float32)
                for t in range(n_hulls)]

    def typed(fn):
        """Σ_t mask_t · fn(type t's vertex table): [V, N] (or [V, 1])."""
        if t_oh is None:
            return fn(0)
        acc = None
        for t in range(n_hulls):
            term = fn(t) * t_oh[t]
            acc = term if acc is None else acc + term
        return acc

    def vcol(t, c):
        return hulls.verts[t][:, c:c + 1]                  # [V, 1]

    wy = typed(lambda t: (vcol(t, 0) * r9[3][None, :]
                          + vcol(t, 1) * r9[4][None, :]
                          + vcol(t, 2) * r9[5][None, :]))
    wy = wy + st.pos[:, 1][None, :]                        # [V, N]
    vmask = typed(lambda t: (
        torch.arange(vcap, device=dev) < hulls.vert_count[t]
    )[:, None].to(torch.float32)) > 0.0
    depth = cfg.ground_height - wy
    valid = (depth > 0.0) & (st.inv_mass > 0.0)[None, :] & vmask
    big_neg = torch.full((), -BIG, dtype=torch.float32, device=dev)
    score = torch.where(valid, depth, big_neg)

    k = min(cfg.max_contacts_per_pair, 8, vcap)
    body = torch.arange(n, dtype=torch.int32, device=dev)
    v_iota = torch.arange(vcap, device=dev)[:, None]
    local = [typed(lambda t, c=c: vcol(t, c)) for c in range(3)]
    pt_c, d_c, act_c, key_c = [[], [], []], [], [], []
    for _ in range(k):
        best = torch.amax(score, dim=0)                    # [N]
        bidx = torch.argmax(score, dim=0)
        oh = (v_iota == bidx[None, :]).to(torch.float32)
        act = best > 0.0
        lx, ly, lz = (torch.sum(oh * local[c], dim=0) for c in range(3))
        for c in range(3):
            pt_c[c].append(st.pos[:, c] + r9[3 * c] * lx
                           + r9[3 * c + 1] * ly + r9[3 * c + 2] * lz)
        d_c.append(torch.where(act, best, 0.0))
        act_c.append(act)
        key_c.append(torch.where(act, -(body * vcap + bidx.to(torch.int32)
                                        + 1), 0).to(torch.int32))
        score = torch.where(oh > 0.0, big_neg, score)

    ck = n * k
    zeros = torch.zeros((ck,), dtype=torch.float32, device=dev)
    return Contacts(
        body_a=body.repeat(k),
        body_b=torch.full((ck,), -1, dtype=torch.int32, device=dev),
        point=torch.stack([torch.cat(c) for c in pt_c]),
        normal=torch.stack([zeros, torch.ones_like(zeros), zeros]),
        depth=torch.cat(d_c),
        active=torch.cat(act_c),
        friction=st.shapes.friction.repeat(k),
        restitution=st.shapes.restitution.repeat(k),
        key=torch.cat(key_c))


def obb_prefilter(st, cand: PairCandidates, cap2: int
                  ) -> Tuple[PairCandidates, Tensor]:
    """The OBB face-axis prefilter: each hull bounded by its type's local
    AABB (padded vertices repeat vertex 0); a pair separated on one of
    the 6 face axes is dropped, the survivors compacted in lane order.
    One type: the first cap2. H > 1 types: segment s = type_a·H + type_b
    holds its first cap2 // H² survivors in lanes [s·seg, (s+1)·seg).
    Returns (candidates, survivors dropped [] int32)."""
    hulls = st.hulls
    n_hulls = hulls.verts.shape[0]
    lo = torch.amin(hulls.verts, dim=1)                    # [H, 3]
    hi = torch.amax(hulls.verts, dim=1)
    co_t = (lo + hi) * 0.5
    h_t = (hi - lo) * 0.5

    ia, ib = cand.body_a.long(), cand.body_b.long()
    tidx = torch.clamp(st.shapes.hull_index, 0, n_hulls - 1).long()
    ta_t = tidx[ia]
    tb_t = tidx[ib]
    if n_hulls == 1:
        co_a = co_b = tuple(co_t[0, c] for c in range(3))
        h_a = h_b = tuple(h_t[0, c] for c in range(3))
    else:
        co_a = tuple(co_t[ta_t, c] for c in range(3))      # [P] rows
        co_b = tuple(co_t[tb_t, c] for c in range(3))
        h_a = tuple(h_t[ta_t, c] for c in range(3))
        h_b = tuple(h_t[tb_t, c] for c in range(3))
    ra9 = v3.quat_to_mat(st.quat[ia])
    rb9 = v3.quat_to_mat(st.quat[ib])

    def obb_center(r9, pos, co):
        return tuple(pos[:, c] + r9[3 * c] * co[0] + r9[3 * c + 1] * co[1]
                     + r9[3 * c + 2] * co[2] for c in range(3))

    ca = obb_center(ra9, st.pos[ia], co_a)
    cb = obb_center(rb9, st.pos[ib], co_b)
    t = v3.sub(cb, ca)
    cabs = [[torch.abs(ra9[i] * rb9[j] + ra9[3 + i] * rb9[3 + j]
                       + ra9[6 + i] * rb9[6 + j]) for j in range(3)]
            for i in range(3)]
    sep = None
    for i in range(3):
        ut = ra9[i] * t[0] + ra9[3 + i] * t[1] + ra9[6 + i] * t[2]
        rad = (h_a[i] + h_b[0] * cabs[i][0] + h_b[1] * cabs[i][1]
               + h_b[2] * cabs[i][2])
        s = torch.abs(ut) - rad
        sep = s if sep is None else torch.maximum(sep, s)
    for j in range(3):
        wt = rb9[j] * t[0] + rb9[3 + j] * t[1] + rb9[6 + j] * t[2]
        rad = (h_b[j] + h_a[0] * cabs[0][j] + h_a[1] * cabs[1][j]
               + h_a[2] * cabs[2][j])
        sep = torch.maximum(sep, torch.abs(wt) - rad)

    keep = cand.mask & (sep < 0.0)
    p = keep.shape[0]
    idx_p = torch.arange(p, dtype=torch.int32, device=keep.device)
    if n_hulls == 1:
        key = torch.where(keep, 0, p) + idx_p
        idx = torch.argsort(key, stable=True)[:cap2]
        kept = keep[idx]
        overflow = torch.clamp(torch.sum(keep.to(torch.int32)) - cap2, min=0)
    else:
        n_seg = n_hulls * n_hulls
        seg_cap = max(cap2 // n_seg, 1)
        sid = ta_t * n_hulls + tb_t                        # [P]
        seg = torch.arange(n_seg, device=keep.device)[:, None]
        keym = torch.where(keep[None, :] & (sid[None, :] == seg),
                           idx_p[None, :], p)              # [n_seg, P]
        keym_s = torch.sort(keym, dim=1, stable=True)[0][:, :seg_cap]
        idx = torch.clamp(keym_s, max=p - 1).reshape(-1)
        kept = (keym_s < p).reshape(-1)
        counts = torch.sum((keym < p).to(torch.int32), dim=1)
        overflow = torch.sum(torch.clamp(counts - seg_cap, min=0))
    packed = torch.stack([cand.body_a, cand.body_b, cand.rank_a,
                          cand.rank_b])[:, idx.long()]
    packed = torch.where(kept[None, :], packed, 0)
    return PairCandidates(packed[0], packed[1], kept, cand.overflow,
                          packed[2], packed[3]), overflow.to(torch.int32)


def _matT_vec(m: tuple, w) -> tuple:
    """Mᵀ·w for a row-major 9-tuple."""
    return (
        m[0] * w[0] + m[3] * w[1] + m[6] * w[2],
        m[1] * w[0] + m[4] * w[1] + m[7] * w[2],
        m[2] * w[0] + m[5] * w[1] + m[8] * w[2],
    )


class Manifolds(NamedTuple):
    """Slot-major manifold pieces of P lanes (S = 2E + 1 slots: 0..2E−1
    the clipped face manifold, 2E the edge contact). World point of face
    slot s = p0 + pu[s]·t1 + pv[s]·t2 + ps[s]·n_ref; `depth` rows are
    validity-masked (> 0 ⇔ a contact)."""

    depth: Tuple
    pu: Tensor
    pv: Tensor
    ps: Tensor
    p0: Tuple
    t1: Tuple
    t2: Tuple
    n_ref: Tuple
    n_face: Tuple
    edge_point: Tuple
    n_edge: Tuple


def manifolds_sm(st, cand: PairCandidates, types=(0, 0)) -> Manifolds:
    """Slot-major manifolds of every lane of one hull type pair: the face
    and edge SAT from the coefficient tables as [rows, 9] × [9, P]
    products, the reference face (ties to the lowest index), the most
    anti-parallel incident face, its polygon clipped against the
    reference face's edges, and the closest points of the best edge
    pair."""
    ht = build_hull_tables(st.hulls, *types)
    ia, ib = cand.body_a.long(), cand.body_b.long()
    p = ia.shape[0]
    dev = st.pos.device
    f = ht.face_n_a.shape[0]
    vc = ht.verts_a.shape[0]
    d2 = ht.ax_mask.shape[0]
    e_cap = ht.face_verts_a.shape[1]
    cap = 2 * e_cap
    f32 = torch.float32

    qa = st.quat[ia]
    qb = st.quat[ib]
    qa_c = torch.stack([qa[:, 0], -qa[:, 1], -qa[:, 2], -qa[:, 3]], dim=-1)
    m9 = v3.quat_to_mat(v3.qmul(qa_c, qb))                 # 9 × [P]
    ra9 = v3.quat_to_mat(qa)
    rb9 = v3.quat_to_mat(qb)
    pa = (st.pos[ia, 0], st.pos[ia, 1], st.pos[ia, 2])
    pb = (st.pos[ib, 0], st.pos[ib, 1], st.pos[ib, 2])
    dp = v3.sub(pb, pa)
    dpa = _matT_vec(ra9, dp)                               # R_aᵀ(p_b−p_a)
    dpb = _matT_vec(rb9, v3.neg(dp))                       # R_bᵀ(p_a−p_b)
    m_mat = torch.stack(m9)                                # [9, P]
    dpa_m = torch.stack(dpa)                               # [3, P]
    dpb_m = torch.stack(dpb)

    # every support
    neg_big = torch.full((), -BIG, dtype=f32, device=dev)
    sa = (ht.a_fv @ m_mat).reshape(f, vc, p)
    sep_a = (torch.amin(sa, dim=1) + ht.face_n_a @ dpa_m
             - ht.face_off_a[:, None])
    sep_a = torch.where(ht.face_mask_a[:, None] > 0, sep_a, neg_big)
    sb = (ht.b_fv @ m_mat).reshape(f, vc, p)
    sep_b = (torch.amin(sb, dim=1) + ht.face_n_b @ dpb_m
             - ht.face_off_b[:, None])
    sep_b = torch.where(ht.face_mask_b[:, None] > 0, sep_b, neg_big)

    s_av = (ht.c_av @ m_mat).reshape(d2, vc, p)
    min_a_e = torch.amin(s_av, dim=1)
    max_a_e = torch.amax(s_av, dim=1)                      # [D², P]
    s_bv = (ht.c_bv @ m_mat).reshape(d2, vc, p)
    min_b_e = torch.amin(s_bv, dim=1)
    max_b_e = torch.amax(s_bv, dim=1)
    axes = (ht.l_ax @ m_mat).reshape(d2, 3, p)
    ax2 = torch.sum(axes * axes, dim=1)                    # [D², P]
    alen = torch.sqrt(torch.clamp(ax2, min=1e-18))
    t_ax = -torch.sum(axes * dpa_m[None], dim=1)           # ax·(p_a−p_b)
    flip = t_ax < 0.0
    sep_num = torch.where(flip, min_b_e - max_a_e - t_ax,
                          min_a_e - max_b_e + t_ax)
    ax_ok = (ht.ax_mask[:, None] > 0) & (alen > 1e-6)
    sep_e = torch.where(ax_ok, sep_num / alen, neg_big)    # [D², P]

    # the axis
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

    # the incident face: the most anti-parallel face of the other hull
    big_col_a = torch.where(ht.face_mask_a > 0, 0.0, BIG)
    big_col_b = torch.where(ht.face_mask_b > 0, 0.0, BIG)
    ff3 = ht.ff.reshape(f, f, 9)

    def align_against_ref(c_tab):
        ce = c_tab.permute(1, 0, 2).reshape(f, f * 9).T @ oh_ref
        return torch.sum(ce.reshape(f, 9, p) * m_mat[None], dim=1)

    al_b = align_against_ref(ff3.permute(1, 0, 2)) + big_col_b[:, None]
    al_a = align_against_ref(ff3) + big_col_a[:, None]
    inc_idx = torch.where(ref_is_a, torch.argmin(al_b, dim=0),
                          torch.argmin(al_a, dim=0))
    oh_inc = (f_iota == inc_idx[None, :]).to(f32)          # [F, P]

    # owner frame → world polygons
    r_ref = tuple(torch.where(ref_is_a, ra9[k], rb9[k]) for k in range(9))
    r_inc = tuple(torch.where(ref_is_a, rb9[k], ra9[k]) for k in range(9))
    p_ref = v3.where(ref_is_a, pa, pb)
    p_inc = v3.where(ref_is_a, pb, pa)

    same = types[0] == types[1]
    poly_a = ht.verts_a[ht.face_verts_a.long()]            # [F, E, 3]
    poly_b = poly_a if same else ht.verts_b[ht.face_verts_b.long()]

    def owner_sel(oh, tab_a, tab_b, ref_side):
        ea = (tab_a.reshape(f, e_cap * 3).T @ oh).reshape(e_cap, 3, p)
        if same:
            return ea
        eb = (tab_b.reshape(f, e_cap * 3).T @ oh).reshape(e_cap, 3, p)
        return torch.where(ref_side[None, None, :], ea, eb)

    ref_loc = owner_sel(oh_ref, poly_a, poly_b, ref_is_a)
    inc_loc = owner_sel(oh_inc, poly_a, poly_b, ~ref_is_a)

    def owner_row(oh, row_a, row_b, ref_side):
        ra_v = (row_a[None] @ oh)[0]
        if same:
            return ra_v
        return torch.where(ref_side, ra_v, (row_b[None] @ oh)[0])

    fcnt_a = ht.face_cnt_a.to(f32)
    fcnt_b = ht.face_cnt_b.to(f32)
    ref_cnt = torch.round(
        owner_row(oh_ref, fcnt_a, fcnt_b, ref_is_a)).to(torch.int32)
    inc_cnt = torch.round(
        owner_row(oh_inc, fcnt_a, fcnt_b, ~ref_is_a)).to(torch.int32)

    def to_world(loc, r, t):
        return [(r[0] * loc[k, 0] + r[1] * loc[k, 1] + r[2] * loc[k, 2] + t[0],
                 r[3] * loc[k, 0] + r[4] * loc[k, 1] + r[5] * loc[k, 2] + t[1],
                 r[6] * loc[k, 0] + r[7] * loc[k, 1] + r[8] * loc[k, 2] + t[2])
                for k in range(loc.shape[0])]

    ref_w = to_world(ref_loc, r_ref, p_ref)
    inc_w = to_world(inc_loc, r_inc, p_inc)

    n_ref_loc = tuple(
        owner_row(oh_ref, ht.face_n_a[:, c].contiguous(),
                  ht.face_n_b[:, c].contiguous(), ref_is_a)
        for c in range(3))
    n_ref = v3.mat_vec(r_ref, n_ref_loc)                   # world, ref→inc
    off_ref = (owner_row(oh_ref, ht.face_off_a, ht.face_off_b, ref_is_a)
               + v3.dot(n_ref, p_ref))

    # the 2-D clip in the reference face's frame
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

    # the edge-edge closest-point contact
    d2_iota = torch.arange(d2, device=dev)[:, None]
    oh_e = (d2_iota == best_e[None, :]).to(f32)            # [D², P]
    ax_sel = tuple(torch.sum(oh_e * axes[:, c, :], dim=0) for c in range(3))
    alen_sel = torch.sum(oh_e * alen, dim=0)
    flip_sel = torch.sum(oh_e * flip.to(f32), dim=0) > 0.5
    sgn = torch.where(flip_sel, -1.0, 1.0)
    ax_u = v3.scale(ax_sel, sgn / torch.clamp(alen_sel, min=1e-9))
    n_edge = v3.mat_vec(ra9, ax_u)                         # world, B → A

    def sel_axis_supports(c_tab):
        ce = c_tab.reshape(d2, vc * 9).T @ oh_e
        return torch.sum(ce.reshape(vc, 9, p) * m_mat[None], dim=1)

    sa_sel = sel_axis_supports(ht.c_av) * sgn[None, :]     # [V, P] A verts
    sb_sel = sel_axis_supports(ht.c_bv) * sgn[None, :]     # [V, P] B verts
    e2 = ht.edge_i0_a.shape[0]

    def one_hot(idx):
        return (idx[:, None] == torch.arange(vc, device=dev)).to(f32)

    oh_i0a, oh_i1a = one_hot(ht.edge_i0_a), one_hot(ht.edge_i1_a)
    if same:
        oh_i0b, oh_i1b = oh_i0a, oh_i1a
    else:
        oh_i0b, oh_i1b = one_hot(ht.edge_i0_b), one_hot(ht.edge_i1_b)
    sa0 = oh_i0a @ sa_sel
    sa1 = oh_i1a @ sa_sel                                  # [E2, P]
    sb0 = oh_i0b @ sb_sel
    sb1 = oh_i1b @ sb_sel
    edge_pad_a = torch.where(ht.edge_mask_a[:, None] > 0, 0.0, BIG)
    edge_pad_b = (edge_pad_a if same else
                  torch.where(ht.edge_mask_b[:, None] > 0, 0.0, BIG))
    score_a = torch.maximum(sa0, sa1) + edge_pad_a
    score_b = torch.minimum(sb0, sb1) - edge_pad_b
    ea_idx = torch.argmin(score_a, dim=0)                  # [P]
    eb_idx = torch.argmax(score_b, dim=0)
    e2_iota = torch.arange(e2, device=dev)[:, None]
    oh_ea = (e2_iota == ea_idx[None, :]).to(f32)           # [E2, P]
    oh_eb = (e2_iota == eb_idx[None, :]).to(f32)

    v0e_a = oh_i0a @ ht.verts_a                            # [E2, 3]
    v1e_a = oh_i1a @ ht.verts_a
    v0e_b = v0e_a if same else oh_i0b @ ht.verts_b
    v1e_b = v1e_a if same else oh_i1b @ ht.verts_b

    def esel(oh, ve):
        return tuple((ve[:, c].contiguous()[None] @ oh)[0] for c in range(3))

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

    # slot-major depth rows, validity folded in
    face_ok = ~separated & ~edge_wins                      # [P]
    depth_rows = []
    for s_i in range(cap):
        d_row = -ps[s_i]
        ok = (s_i < m_cnt) & (d_row > 0.0) & face_ok
        depth_rows.append(torch.where(ok, d_row, zero))
    depth_rows.append(torch.where(edge_wins & (edge_depth > 0.0),
                                  edge_depth, zero))
    return Manifolds(
        depth=tuple(depth_rows), pu=pu, pv=pv, ps=ps,
        p0=p0, t1=t1, t2=t2, n_ref=n_ref, n_face=n_face,
        edge_point=edge_point, n_edge=n_edge)


def select_rows(st, cand: PairCandidates, cfg, types) -> dict:
    """One type-pair segment's pair contacts: its manifolds and kk argmax
    passes over the S slot depths (ties to the lowest slot). Returns
    {field: [P] row, or kk rows for the slot-major fields}."""
    ia, ib = cand.body_a, cand.body_b
    p = ia.shape[0]
    sm = manifolds_sm(st, cand, types)
    cap = sm.pu.shape[0]
    ns = cap + 1                                           # slots + edge

    btab = torch.stack([
        (st.inv_mass > 0).to(torch.float32),
        st.shapes.friction,
        st.shapes.restitution,
    ])
    ta = btab[:, ia.long()]                                # [3, P]
    tb = btab[:, ib.long()]
    base_valid = cand.mask & ((ta[0] > 0) | (tb[0] > 0))

    big_neg = torch.full((), -BIG, dtype=torch.float32, device=ia.device)
    score = [torch.where(base_valid & (sm.depth[s] > 0.0), sm.depth[s],
                         big_neg) for s in range(ns)]

    n = st.num_bodies
    has_key = n * n * ns < 2**31 - 1
    base_key = ((torch.minimum(ia, ib) * n + torch.maximum(ia, ib)) * ns
                if has_key else None)
    kk = min(cfg.max_contacts_per_pair, ns)
    out = {"ia": ia, "ib": ib, "mu": torch.sqrt(ta[1] * tb[1]),
           "rest": torch.maximum(ta[2], tb[2]), "kk": kk,
           "d": [], "act": [], "key": [],
           **{f"{f}{c}": [] for f in ("pt", "nm") for c in range(3)}}
    zero_p = torch.zeros((p,), dtype=torch.float32, device=ia.device)
    pu_rows = list(sm.pu.unbind(0)) + [zero_p]
    pv_rows = list(sm.pv.unbind(0)) + [zero_p]
    ps_rows = list(sm.ps.unbind(0)) + [zero_p]
    for _ in range(kk):
        best, bidx = _argmax_unrolled(score)
        act = best > 0.0
        is_edge = bidx == cap
        u_sel = _select(bidx, pu_rows)
        v_sel = _select(bidx, pv_rows)
        s_sel = _select(bidx, ps_rows)
        for c in range(3):
            pt_face = (sm.p0[c] + u_sel * sm.t1[c] + v_sel * sm.t2[c]
                       + s_sel * sm.n_ref[c])
            out[f"pt{c}"].append(torch.where(is_edge, sm.edge_point[c],
                                             pt_face))
            out[f"nm{c}"].append(torch.where(is_edge, sm.n_edge[c],
                                             sm.n_face[c]))
        out["d"].append(torch.where(act, best, zero_p))
        out["act"].append(act)
        out["key"].append(torch.where(act, base_key + bidx, 0)
                          if has_key else torch.zeros_like(ia))
        score = [torch.where(bidx == s, big_neg, score[s])
                 for s in range(ns)]
    return out


def pair_contacts(st, cand: PairCandidates, cfg) -> Contacts:
    """Slot-major [kk·P] pair contacts: one hull type, or the type-pair
    segments the prefilter lays out, each from its own tables. Slot row k
    is every segment's k-th row, in segment order. Keys are (min·n +
    max)·S + slot while n²·S < 2³¹ − 1, else 0."""
    n_hulls = st.hulls.verts.shape[0]
    if n_hulls == 1:
        segs = [(cand, (0, 0))]
    else:
        n_seg = n_hulls * n_hulls
        seg_cap = cand.body_a.shape[0] // n_seg
        segs = []
        for s in range(n_seg):
            sl = slice(s * seg_cap, (s + 1) * seg_cap)
            segs.append((PairCandidates(
                cand.body_a[sl], cand.body_b[sl], cand.mask[sl],
                cand.overflow, cand.rank_a[sl], cand.rank_b[sl]),
                (s // n_hulls, s % n_hulls)))
    parts = [select_rows(st, c_s, cfg, types) for c_s, types in segs]
    kk = parts[0]["kk"]

    def slotcat(field):
        return torch.cat([pt[field][k] for k in range(kk) for pt in parts])

    def repcat(field):
        return torch.cat([pt[field] for pt in parts]).repeat(kk)

    return Contacts(
        body_a=repcat("ia"), body_b=repcat("ib"),
        point=torch.stack([slotcat(f"pt{c}") for c in range(3)]),
        normal=torch.stack([slotcat(f"nm{c}") for c in range(3)]),
        depth=slotcat("d"), active=slotcat("act"),
        friction=repcat("mu"), restitution=repcat("rest"),
        key=slotcat("key"))


def contact_list(st, cfg):
    """The step's contact list: (contacts, (lo, rank_b) [C] endpoint
    ranks, the sweep order, the rank-space geometry table at the solve's
    width, the prefiltered candidates, the solve's contact slots,
    {pair_overflow, prefilter_overflow})."""
    n = st.num_bodies
    dev = st.device
    aabbs = hull_aabbs(st)
    order = sweep_order(st, aabbs)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    rank[order.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    cp = contact_capacity(st, cfg)
    npad = solve_shape(n, cp, cfg)[2]
    geom = torch.zeros((48, npad), dtype=torch.float32, device=dev)
    geom[:, :n] = hull_geom(st, cfg, order)[:, :n]
    cand = compact_pairs(
        sweep_candidates(order, aabbs, min(cfg.sweep_window, n - 1)),
        cfg.max_pair_candidates)
    counters = {"pair_overflow": cand.overflow}
    groups, lo, rb = [], [], []
    if cfg.ground_plane:
        gc = ground_contacts(st, cfg)
        kg = gc.body_a.shape[0] // n
        groups.append(gc)
        lo.append(rank.repeat(kg))
        rb.append(torch.full((kg * n,), -1, dtype=torch.int32, device=dev))
    if cfg.hull_prefilter_cap > 0:
        cand, counters["prefilter_overflow"] = obb_prefilter(
            st, cand, cfg.hull_prefilter_cap)
    pc = pair_contacts(st, cand, cfg)
    kk = pc.body_a.shape[0] // cand.body_a.shape[0]
    groups.append(pc)
    lo.append(cand.rank_a.repeat(kk))
    rb.append(cand.rank_b.repeat(kk))
    return (concat_contacts(*groups), (torch.cat(lo), torch.cat(rb)), order,
            geom, cand, cp, counters)
