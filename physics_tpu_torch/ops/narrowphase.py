"""Narrow phase (physics_tpu/ops/narrowphase.py): the flat contact buffer
(`Contacts`, `concat_contacts`), the boxes-only ground corners
(`_ground_contacts_boxes`), the banded pair manifolds' slot-major
contacts (`_pair_contacts_boxes_pallas`), their boxes-only dispatch, the
generic banded branch's whole contact list in one kernel launch
(`banded_contacts`, csrc/narrowphase_banded.cu), the hull fast-layout
predicate (`hulls_fast_path`) and the generic hull path's narrow phase
on it: the OBB face-axis prefilter (`hull_obb_prefilter`), the hull
vertices against the ground (`_ground_contacts_hulls_fast`) and the
slot-major pair contacts (`_pair_contacts_hulls_fast`) from the
manifolds of ops/hullhull_batched.py.

The JAX package picks the box ground path by backend: on the TPU the
slot-major `_ground_contacts_boxes` ([k·N], slot s of every body, then
slot s+1), elsewhere the generic body-major `ground_contacts` over
`convex_data`. The port follows the TPU route on every device, so its
contact order within a rank differs from the JAX package's on the CPU.
The hull fast paths are the same on every backend there. The generic
convex narrow phases (`convex_data`, spheres) are ROADMAP item 1.13.2.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from physics_tpu_torch import tracing
from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops import hullhull_batched
from physics_tpu_torch.ops.boxbox_batched import (
    _CAP,
    _argmax_unrolled,
    _select,
)
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.ops.contact_table import _BOX_SIGNS
from physics_tpu_torch.ops.narrowphase_banded import (
    NP_ID_EXACT_MAX,
    _static_bases,
    body_table_width,
    np_shape,
    pair_manifolds_banded,
)
from physics_tpu_torch.parallel.collectives import Shard, chunk, chunk_contacts
from physics_tpu_torch.state import SHAPE_BOX, SHAPE_HULL, SimState

Tensor = torch.Tensor

MAX_FAST_HULL_TYPES = 4   # H² coefficient-table sets + H² segments


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
    key: Tensor          # [C] int32 feature id (pairs ≥ 0, ground < 0,
                         # 0 on inactive slots)


def concat_contacts(*groups: Contacts) -> Contacts:
    groups = [g for g in groups if g is not None and g.body_a.shape[0] > 0]
    if len(groups) == 1:
        return groups[0]
    return Contacts(*[
        torch.cat([getattr(g, f) for g in groups],
                  dim=1 if f in ("point", "normal") else 0)
        for f in Contacts._fields
    ])


def hulls_fast_path(state: SimState, cfg: SimConfig) -> bool:
    """True when the scene is hulls-only with a small hull library: one
    hull type, or up to MAX_FAST_HULL_TYPES with the OBB prefilter that
    segments candidates by type pair. Depends on cfg and shapes only."""
    n_hulls = state.hulls.verts.shape[0]
    return bool(
        cfg.hulls_only and cfg.hull_fast
        and 1 <= n_hulls <= MAX_FAST_HULL_TYPES
        and (n_hulls == 1 or cfg.hull_prefilter_cap > 0)
        and state.hulls.verts.shape[1] > 1
    )


def banded_pairs(cfg: SimConfig) -> bool:
    """True when pair contacts come from the banded pair-manifold kernel
    (the bucketed sweep bounds every tile's rank span)."""
    return bool(cfg.boxes_only and cfg.narrowphase_pallas
                and cfg.broadphase == "sweep" and cfg.pair_buckets)


def _ground_contacts_boxes(state: SimState, cfg: SimConfig) -> Contacts:
    """The 8 box corners against y = ground_height, the deepest
    min(max_contacts_per_pair, 8) per body, slot-major [k·N]. Ground keys
    are −(body·8 + corner + 1)."""
    n = state.num_bodies
    k = min(cfg.max_contacts_per_pair, 8)
    r9 = v3.quat_to_mat(state.quat)
    hx, hy, hz = (state.shapes.params[:, 0], state.shapes.params[:, 1],
                  state.shapes.params[:, 2])
    px, py, pz = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    valid_base = (state.inv_mass > 0.0) & (state.shapes.stype == SHAPE_BOX)

    pts, score = [], []
    for sx, sy, sz in _BOX_SIGNS:
        wx, wy, wz = sx * hx, sy * hy, sz * hz
        cx = px + r9[0] * wx + r9[1] * wy + r9[2] * wz
        cy = py + r9[3] * wx + r9[4] * wy + r9[5] * wz
        cz = pz + r9[6] * wx + r9[7] * wy + r9[8] * wz
        pts.append((cx, cy, cz))
        d = cfg.ground_height - cy
        score.append(torch.where(valid_base & (d > 0.0), d,
                                 torch.full_like(d, -float("inf"))))

    body = torch.arange(n, dtype=torch.int32, device=state.device)
    sel_p, sel_d, sel_a, sel_k = [[], [], []], [], [], []
    for _ in range(k):
        best, bidx = _argmax_unrolled(score)
        active = torch.isfinite(best) & (best > 0.0)
        pt = _select(bidx, pts)
        for c in range(3):
            sel_p[c].append(pt[c])
        sel_d.append(torch.where(active, best, torch.zeros_like(best)))
        sel_a.append(active)
        sel_k.append(torch.where(active, -(body * 8 + bidx + 1),
                                 torch.zeros_like(body)))
        score = [torch.where(bidx == s, torch.full_like(score[s],
                                                        -float("inf")),
                             score[s]) for s in range(8)]

    zeros = torch.zeros((k * n,), dtype=torch.float32, device=state.device)
    return Contacts(
        body_a=body.repeat(k),
        body_b=torch.full((k * n,), -1, dtype=torch.int32,
                          device=state.device),
        point=torch.stack([torch.cat(sel_p[c]) for c in range(3)]),
        normal=torch.stack([zeros, torch.ones_like(zeros), zeros]),
        depth=torch.cat(sel_d),
        active=torch.cat(sel_a),
        friction=state.shapes.friction.repeat(k),
        restitution=state.shapes.restitution.repeat(k),
        key=torch.cat(sel_k),
    )


def _pair_contacts_boxes_pallas(state: SimState, cand: PairCandidates,
                                cfg: SimConfig, geom: Tensor,
                                chunked: bool = False) -> Contacts:
    """The banded pair-manifold kernel's rows (ops/narrowphase_banded.py)
    as slot-major [kk·P] contacts. `geom` is the rank-space geometry table
    of the step (its narrow-phase block is the kernel's body table). Pair
    keys are (min id·n + max id)·8 + source slot while n²·8 fits in int32,
    else 0; the endpoint ids ride the kernel's rows."""
    n = state.num_bodies
    p0 = cand.body_a.shape[0]
    rows, _, kk = pair_manifolds_banded(state, cand, cfg, geom,
                                        chunked=chunked)
    if n < NP_ID_EXACT_MAX:
        zero = torch.zeros_like(cand.body_a)
        ia = torch.where(cand.mask, rows[5 * kk + 5, :p0].to(torch.int32),
                         zero)
        ib = torch.where(cand.mask, rows[5 * kk + 6, :p0].to(torch.int32),
                         zero)
    else:
        ia, ib = cand.body_a, cand.body_b

    has_key = n * n * _CAP < 2**31 - 1
    if has_key:
        base_key = (torch.minimum(ia, ib) * n + torch.maximum(ia, ib)) * _CAP
    point_c, depth_c, act_c, key_c = [[], [], []], [], [], []
    for s in range(kk):
        for c in range(3):
            point_c[c].append(rows[5 * s + c, :p0])
        d = rows[5 * s + 3, :p0]
        depth_c.append(d)
        active = d > 0.0
        act_c.append(active)
        if has_key:
            bidx = rows[5 * s + 4, :p0].to(torch.int32)
            key_c.append(torch.where(active, base_key + bidx,
                                     torch.zeros_like(base_key)))
        else:
            key_c.append(torch.zeros_like(ia))

    return Contacts(
        body_a=ia.repeat(kk),
        body_b=ib.repeat(kk),
        point=torch.stack([torch.cat(point_c[c]) for c in range(3)]),
        normal=rows[5 * kk:5 * kk + 3, :p0].repeat(1, kk),
        depth=torch.cat(depth_c),
        active=torch.cat(act_c),
        friction=rows[5 * kk + 3, :p0].repeat(kk),
        restitution=rows[5 * kk + 4, :p0].repeat(kk),
        key=torch.cat(key_c),
    )


def hull_obb_prefilter(state: SimState, cand: PairCandidates, cap2: int
                       ) -> Tuple[PairCandidates, Tensor]:
    """The generic hull path's OBB face-axis prefilter: each hull is
    bounded by its type's local AABB (padded vertices repeat vertex 0, so
    the min/max over the capacity is exact); a pair separated on one of
    the 6 face axes of the two boxes is dropped, and the survivors are
    compacted in lane order. One hull type: the first `cap2`. H > 1
    types: segmented by ordered type pair, segment s = type_a·H + type_b
    holding its first cap2 // H² survivors in lanes [s·seg, (s+1)·seg).
    The rank rows ride the compaction; lanes past the survivors are 0.
    Returns (candidates, survivors dropped [] int32)."""
    hulls = state.hulls
    n_hulls = hulls.verts.shape[0]
    lo = torch.amin(hulls.verts, dim=1)                    # [H, 3]
    hi = torch.amax(hulls.verts, dim=1)
    co_t = (lo + hi) * 0.5
    h_t = (hi - lo) * 0.5

    ia, ib = cand.body_a.long(), cand.body_b.long()
    tidx = torch.clamp(state.shapes.hull_index, 0, n_hulls - 1).long()
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
    ra9 = v3.quat_to_mat(state.quat[ia])
    rb9 = v3.quat_to_mat(state.quat[ib])

    def obb_center(r9, pos, co):
        return tuple(pos[:, c] + r9[3 * c] * co[0] + r9[3 * c + 1] * co[1]
                     + r9[3 * c + 2] * co[2] for c in range(3))

    ca = obb_center(ra9, state.pos[ia], co_a)
    cb = obb_center(rb9, state.pos[ib], co_b)
    t = v3.sub(cb, ca)
    # |column_i(Ra) · column_j(Rb)|: the face-axis radius terms
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
        # unique keys: the kept lanes keep their index, the others shift
        # past P, so the sort keeps lane order
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


def _ground_contacts_hulls_fast(state: SimState, cfg: SimConfig
                                ) -> Contacts:
    """Hull vertices against y = ground_height, slot-major [k·N], k =
    min(max_contacts_per_pair, 8, V): the world heights of every body's
    vertices as one [V, N] table, the deepest k per body by k argmax
    passes (ties to the lowest vertex), world points built only for the
    picked vertices. Keys are −(body·V + vertex + 1)."""
    n = state.num_bodies
    dev = state.device
    n_hulls = state.hulls.verts.shape[0]
    vcap = state.hulls.verts.shape[1]
    r9 = v3.quat_to_mat(state.quat)                        # 9 × [N]
    if n_hulls == 1:
        t_oh = None
    else:
        tidx = torch.clamp(state.shapes.hull_index, 0, n_hulls - 1)
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
        return state.hulls.verts[t][:, c:c + 1]            # [V, 1]

    wy = typed(lambda t: (vcol(t, 0) * r9[3][None, :]
                          + vcol(t, 1) * r9[4][None, :]
                          + vcol(t, 2) * r9[5][None, :]))
    wy = wy + state.pos[:, 1][None, :]                     # [V, N]
    vmask = typed(lambda t: (
        torch.arange(vcap, device=dev) < state.hulls.vert_count[t]
    )[:, None].to(torch.float32)) > 0.0
    depth = cfg.ground_height - wy
    valid = (depth > 0.0) & (state.inv_mass > 0.0)[None, :] & vmask
    big_neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
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
            pt_c[c].append(state.pos[:, c] + r9[3 * c] * lx
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
        friction=state.shapes.friction.repeat(k),
        restitution=state.shapes.restitution.repeat(k),
        key=torch.cat(key_c),
    )


def _hull_fast_select_rows(state: SimState, cand: PairCandidates,
                           cfg: SimConfig, types) -> dict:
    """One type-pair segment of the hull pair contacts: its slot-major
    manifolds and kk argmax passes over the S = 2E + 1 slot depths (ties
    to the lowest slot). Returns {field: [P] row, or kk rows for the
    slot-major fields}. The manifolds run in tracing's list_manifolds
    stage, the picks in list_select."""
    ia, ib = cand.body_a, cand.body_b
    p = ia.shape[0]
    tracing.stage("list_manifolds", ia.device)
    sm, separated = hullhull_batched.shared_hull_manifolds_sm(
        state, cand, types, with_separated=True)
    sink = tracing.slots("list_sat_lanes", 2)
    if sink is not None:
        sink.add_(torch.stack([cand.mask.sum(),
                               (cand.mask & ~separated).sum()]))
    tracing.stage("list_select", ia.device)
    cap = sm.pu.shape[0]
    ns = cap + 1                                           # slots + edge

    btab = torch.stack([
        (state.inv_mass > 0).to(torch.float32),
        (state.shapes.stype == SHAPE_HULL).to(torch.float32),
        state.shapes.friction,
        state.shapes.restitution,
    ])
    ta = btab[:, ia.long()]                                # [4, P]
    tb = btab[:, ib.long()]
    movable = (ta[0] > 0) | (tb[0] > 0)
    base_valid = cand.mask & movable & (ta[1] > 0) & (tb[1] > 0)

    big_neg = torch.full((), -1e30, dtype=torch.float32, device=ia.device)
    score = [torch.where(base_valid & (sm.depth[s] > 0.0), sm.depth[s],
                         big_neg) for s in range(ns)]

    n = state.num_bodies
    has_key = n * n * ns < 2**31 - 1
    base_key = ((torch.minimum(ia, ib) * n + torch.maximum(ia, ib)) * ns
                if has_key else None)
    kk = min(cfg.max_contacts_per_pair, ns)
    out = {"ia": ia, "ib": ib, "mu": torch.sqrt(ta[2] * tb[2]),
           "rest": torch.maximum(ta[3], tb[3]), "kk": kk,
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


def hull_segments(state: SimState, cand: PairCandidates):
    """The type-pair segments of the generic hull path's candidates:
    [(first lane, lanes, (type_a, type_b))], one for one hull type, else
    hull_obb_prefilter's H² segments of equal widths, segment s = type_a·H
    + type_b."""
    n_hulls = state.hulls.verts.shape[0]
    p_tot = cand.body_a.shape[0]
    if n_hulls == 1:
        return [(0, p_tot, (0, 0))]
    n_seg = n_hulls * n_hulls
    seg_cap = p_tot // n_seg
    if seg_cap * n_seg != p_tot:
        raise ValueError(
            "the multi-type hull fast path needs type-pair-segmented "
            "candidates (hull_obb_prefilter: cfg.hull_prefilter_cap > 0)")
    return [(s * seg_cap, seg_cap, (s // n_hulls, s % n_hulls))
            for s in range(n_seg)]


def _pair_contacts_hulls_fast(state: SimState, cand: PairCandidates,
                              cfg: SimConfig) -> Contacts:
    """Slot-major [kk·P] pair contacts of the generic hull path: one hull
    type, or the type-pair segments hull_obb_prefilter lays out
    (hull_segments), each from its own coefficient tables. Slot row k is
    every segment's k-th row, in segment order, mirroring the rank rows
    cat([rank] · kk). Keys are (min·n + max)·S + slot while n²·S < 2³¹ −
    1, else 0. The plain version of ops/hull_list.hull_pair_contacts."""
    segs = []
    for lane0, p, types in hull_segments(state, cand):
        sl = slice(lane0, lane0 + p)
        segs.append((PairCandidates(
            cand.body_a[sl], cand.body_b[sl], cand.mask[sl], cand.overflow,
            cand.rank_a[sl], cand.rank_b[sl]), types))
    parts = [_hull_fast_select_rows(state, c_s, cfg, types)
             for c_s, types in segs]
    kk = parts[0]["kk"]

    def slotcat(field):
        return torch.cat([pt[field][k] for k in range(kk) for pt in parts])

    def repcat(field):
        return torch.cat([pt[field] for pt in parts]).repeat(kk)

    return Contacts(
        body_a=repcat("ia"),
        body_b=repcat("ib"),
        point=torch.stack([slotcat(f"pt{c}") for c in range(3)]),
        normal=torch.stack([slotcat(f"nm{c}") for c in range(3)]),
        depth=slotcat("d"),
        active=slotcat("act"),
        friction=repcat("mu"),
        restitution=repcat("rest"),
        key=slotcat("key"),
    )


def _check_ported(cfg: SimConfig, ground: bool, pairs: bool,
                  hulls: bool = False) -> None:
    """`hulls`: the scene takes the hull fast layout (hulls_fast_path)."""
    if ground and not (cfg.boxes_only or hulls):
        raise NotImplementedError(
            "ground contacts of spheres, and of hulls outside the fast "
            "layout (convex_data), are ROADMAP item 1.13.2")
    if pairs and not (banded_pairs(cfg) or hulls):
        raise NotImplementedError(
            "only the banded box narrow phase (boxes_only, "
            "narrowphase_pallas, bucketed sweep) and the hull fast layout "
            "are ported; the generic narrow phases are ROADMAP items "
            "1.13.2-1.13.3")


def ground_contacts(state: SimState, cfg: SimConfig) -> Contacts:
    """Ground contacts: the hull fast layout's vertices, else a boxes-only
    scene's corners (the TPU route of the JAX dispatch)."""
    hulls = hulls_fast_path(state, cfg)
    _check_ported(cfg, ground=True, pairs=False, hulls=hulls)
    if hulls:
        return _ground_contacts_hulls_fast(state, cfg)
    return _ground_contacts_boxes(state, cfg)


def pair_contacts(state: SimState, cand: PairCandidates, cfg: SimConfig,
                  geom: Tensor | None = None,
                  chunked: bool = False) -> Contacts:
    """Pair contacts of the candidates: the hull fast layout's slot-major
    manifolds, else the banded box manifolds' plain rows of the bucketed
    candidates (`chunked`: one rank's slice of them), which read the
    rank-space geometry table `geom`."""
    hulls = hulls_fast_path(state, cfg)
    _check_ported(cfg, ground=False, pairs=True, hulls=hulls)
    if hulls:
        return _pair_contacts_hulls_fast(state, cand, cfg)
    return _pair_contacts_boxes_pallas(state, cand, cfg, geom,
                                       chunked=chunked)


def banded_contacts_plain(state: SimState, cfg: SimConfig, rank: Tensor,
                          cand: PairCandidates | None, geom: Tensor,
                          shard: Shard | None = None):
    """Plain version of `banded_contacts`: the ground corners, their rank
    rows and (under `shard`) this rank's slice of them, then the pair
    contacts of this rank's candidate lanes (the manifold rows in chunked
    mode under `shard`) with theirs, concatenated."""
    n = state.num_bodies
    groups = []
    if cfg.ground_plane:
        gc = ground_contacts(state, cfg)
        kg = gc.body_a.shape[0] // n
        lo = rank.repeat(kg)
        rb = torch.full((kg * n,), -1, dtype=torch.int32, device=rank.device)
        if shard is not None:
            gc = chunk_contacts(gc, shard)
            lo, rb = chunk(lo, shard), chunk(rb, shard)
        groups.append((gc, lo, rb))
    n_ground = groups[0][0].body_a.shape[0] if groups else 0
    if cand is not None:
        cand_l = cand if shard is None else PairCandidates(*[
            x if x.dim() == 0 else chunk(x, shard) for x in cand])
        pc = pair_contacts(state, cand_l, cfg, geom, chunked=shard is not None)
        kk = pc.body_a.shape[0] // max(cand_l.body_a.shape[0], 1)
        groups.append((pc, cand_l.rank_a.repeat(kk), cand_l.rank_b.repeat(kk)))
    return (concat_contacts(*[g[0] for g in groups]),
            torch.cat([g[1] for g in groups]),
            torch.cat([g[2] for g in groups]), n_ground)


# np_banded_contacts flags
_FLAG_CHUNKED = 1          # window bases from each tile's lanes (shard)
_FLAG_IDS_FROM_ROWS = 2    # endpoint ids from the body table's rows
_FLAG_KEYS = 4             # pair keys fit int32


def _launch_kernel(state: SimState, cfg: SimConfig, rank: Tensor,
                   cand: PairCandidates | None, geom: Tensor,
                   shard: Shard | None):
    from physics_tpu_torch import _build

    dev = geom.device
    n = state.num_bodies
    i32, f32 = torch.int32, torch.float32
    r, size = (shard.rank, shard.size) if shard is not None else (0, 1)
    g0 = g_count = kg = 0
    if cfg.ground_plane:
        kg = min(cfg.max_contacts_per_pair, len(_BOX_SIGNS))
        g_count = -(-kg * n // size)
        g0 = r * g_count
    p_total = j0 = p_count = tile = kk = 0
    flags = 0
    bases = None
    wtot = cfg.pallas_window
    npad = geom.shape[1]
    if cand is not None:
        p_total = cand.body_a.shape[0]
        p_count = -(-p_total // size)
        j0 = r * p_count
        kk, tile, _ = np_shape(n, p_count, cfg)
        if tuple(geom.shape) != (48, body_table_width(n, cfg)):
            raise ValueError(f"banded contacts: pass the rank-space geometry "
                             f"table [48, {body_table_width(n, cfg)}]")
        if shard is not None:
            flags |= _FLAG_CHUNKED
            if tile % 128:
                raise ValueError(f"banded contacts: chunked mode needs a "
                                 f"tile of 128·k lanes (got {tile})")
        elif p_count:
            bases = _static_bases(n, p_count, cfg, dev)
        if n < NP_ID_EXACT_MAX:
            flags |= _FLAG_IDS_FROM_ROWS
        if n * n * _CAP < 2**31 - 1:
            flags |= _FLAG_KEYS
    sh = state.shapes
    ops = [("pos", state.pos.contiguous(), f32, (n, 3)),
           ("quat", state.quat.contiguous(), f32, (n, 4)),
           ("params", sh.params.contiguous(), f32, (n, 3)),
           ("inv_mass", state.inv_mass.contiguous(), f32, (n,)),
           ("stype", sh.stype.contiguous(), i32, (n,)),
           ("friction", sh.friction.contiguous(), f32, (n,)),
           ("restitution", sh.restitution.contiguous(), f32, (n,)),
           ("rank", rank, i32, (n,)),
           ("geom", geom, f32, (48, npad))]
    if cand is not None:
        ops += [("mask", cand.mask, torch.bool, (p_total,))] + [
            (name, getattr(cand, name), i32, (p_total,))
            for name in ("rank_a", "rank_b", "body_a", "body_b")]
    _build.check_operands("banded contacts", dev, *ops)
    t = {name: x for name, x, _, _ in ops}
    c = g_count + kk * p_count
    fout = torch.empty((9, c), dtype=f32, device=dev)
    iout = torch.empty((5, c), dtype=i32, device=dev)
    active = torch.empty((c,), dtype=torch.bool, device=dev)

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)
    with torch.cuda.device(dev):
        err = _build.library().np_banded_contacts(
            *[ptr(t[k]) for k in ("pos", "quat", "params", "inv_mass",
                                  "stype", "friction", "restitution",
                                  "rank", "geom")],
            ptr(bases),
            *[ptr(t.get(k)) for k in ("mask", "rank_a", "rank_b", "body_a",
                                      "body_b")],
            ptr(fout), ptr(iout), ptr(active), n, kg, g0, g_count,
            ctypes.c_float(cfg.ground_height), p_total, j0, p_count, tile,
            npad, wtot, kk, flags,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "np_banded_contacts")
    banded_contacts.launches += 1
    contacts = Contacts(
        body_a=iout[0], body_b=iout[1], point=fout[0:3], normal=fout[3:6],
        depth=fout[6], active=active, friction=fout[7],
        restitution=fout[8], key=iout[2])
    return contacts, iout[3], iout[4], g_count


def banded_contacts(state: SimState, cfg: SimConfig, rank: Tensor,
                    cand: PairCandidates | None, geom: Tensor,
                    plain: bool = False, shard: Shard | None = None):
    """The generic banded branch's box contact list: the ground corners
    (slot-major [k·N], if cfg.ground_plane) then the pair contacts of the
    bucketed candidates (slot-major [kk·P], if `cand`), each with its
    endpoint ranks. `rank` [N] int32 is each body's sweep rank, `geom` the
    rank-space geometry table at body_table_width. With `shard`, this
    rank's slice of the ground slots and of the candidate lanes (the
    manifolds in chunked mode), as `chunk` would cut them. Returns
    (Contacts, lo [C] (rank of body_a), rank_b [C] (−1: the ground), the
    count of ground slots, which come first).

    A CPU tensor (or `plain=True`) runs the plain composition; a CUDA
    tensor launches csrc/narrowphase_banded.cu, which writes every field
    in place of the composition's element-wise glue.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    _check_ported(cfg, cfg.ground_plane, cand is not None)
    if plain or geom.device.type == "cpu":
        return banded_contacts_plain(state, cfg, rank, cand, geom, shard)
    if geom.device.type != "cuda":
        raise ValueError(f"banded contacts: unsupported device {geom.device}")
    return _launch_kernel(state, cfg, rank, cand, geom, shard)


banded_contacts.launches = 0
