"""The hull contact table, plain PyTorch: a frozen copy of the port's
plain hull-table path, cut to scenes whose every body is a hull of a
library of at most 3 types. From ops/hullhull_batched.py the linear
SAT's coefficient tables of an ordered type pair (`build_hull_tables`);
from ops/hull_table.py their kernel layout (`build_hull_coef`, stacked
over the type pairs, with the edge indices and ground vertex biases),
the per-lane SAT, incident face, reference-face clip and edge-edge
point (`_sat_pass`) and the table itself
(`bucket_hull_contact_table_plain`: the OBB prefilter, the SAT of each
lane's type pair, the kk deepest slots, the kg lowest vertices of each
rank on the ground, then the box table's compaction and warm match);
from ops/contact_table.py the geometry table in hull mode and the
hulls' OBB prefilter; from ops/broadphase.py the hulls' AABBs (a
sphere of the hull's bounding radius).

Departures from the port: the library's tables are kept on the
reference's hull library (`hull_table_coef`) rather than its HullSet's
cache, and the table's operand checks that a run of the benchmark
cannot fail (type count, key range) are left out.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from portbench.reference import vec as v3
from portbench.reference.boxbox import _argmax_unrolled, _clip, _select
from portbench.reference.state import Config, State
from portbench.reference.table import (
    BLOCK,
    CT2_ROWS,
    CT_ROWS,
    PairCandidates,
    _bucket_starts,
    _compact_lanes,
    _face_sat_sep,
    _t_apply,
    compact_emissions,
    geom_pad,
    lane_geometry,
    table_operands,
)

Tensor = torch.Tensor

BIG = 1e30


def hull_aabbs(state: State) -> Tensor:
    """World AABBs [N, 2, 3] (min, max): the sphere of radius params[0]
    (the hull's bounding radius, set at scene build)."""
    params = state.shapes.params
    ext = params[:, 0:1].expand(params.shape[0], 3)
    return torch.stack([state.pos - ext, state.pos + ext], dim=-2)


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


def _hull_boxes(hs) -> Tuple[Tensor, Tensor]:
    """(centre, half extents) [H, 3] of each hull type's local AABB."""
    vcap = hs.verts.shape[1]
    vmask = (torch.arange(vcap, device=hs.verts.device)[None, :]
             < hs.vert_count[:, None])[..., None]           # [H, V, 1]
    big = torch.full_like(hs.verts, 1e30)
    lo_t = torch.amin(torch.where(vmask, hs.verts, big), dim=1)
    hi_t = torch.amax(torch.where(vmask, hs.verts, -big), dim=1)
    return (lo_t + hi_t) * 0.5, (hi_t - lo_t) * 0.5


def hull_geom(state: State, cfg: Config, order: Tensor | None) -> Tensor:
    """The rank-space geometry table [48, NPAD] in hull mode
    (ops/contact_table.unified_geom_plain with hulls=True, every body a
    hull): rows 0:24 the solve block, rows 24:48 the narrow-phase block
    with the hull type's local-AABB half extents, row 43 1 + hull type,
    rows 44:47 the world OBB centre pos + R·(local-AABB centre), then
    0."""
    n = state.num_bodies
    _, npad = geom_pad(n, cfg)
    movable = (state.inv_mass > 0.0).to(torch.float32)
    r9 = v3.quat_to_mat(state.quat)
    iw9 = v3.sandwich(r9, v3.mat_unpack(state.inv_inertia))
    zero = torch.zeros((n,), dtype=torch.float32, device=state.device)
    pos3 = [state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]]
    nh = state.hulls.verts.shape[0]
    co_t, hh_t = _hull_boxes(state.hulls)
    hidx = torch.clamp(state.shapes.hull_index, 0, nh - 1).long()
    co_b = co_t[hidx]                                   # [n, 3]
    hh_b = hh_t[hidx]
    half3 = [hh_b[:, 0], hh_b[:, 1], hh_b[:, 2]]
    tail = [pos3[c] + r9[3 * c] * co_b[:, 0]
            + r9[3 * c + 1] * co_b[:, 1]
            + r9[3 * c + 2] * co_b[:, 2] for c in range(3)] + [zero]
    is_shape = 1.0 + hidx.to(torch.float32)
    rows = torch.stack(
        pos3 + list(iw9)
        + [state.inv_mass,
           state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
           state.omega[:, 0], state.omega[:, 1], state.omega[:, 2],
           state.quat[:, 0], state.quat[:, 1], state.quat[:, 2],
           state.quat[:, 3], zero]
        + pos3 + list(r9) + half3
        + [state.shapes.friction, state.shapes.restitution,
           movable * is_shape,
           torch.arange(n, dtype=torch.float32, device=state.device),
           is_shape]
        + tail)                                            # [48, N]
    if order is not None:
        rows = rows[:, order.long()]
    geom = torch.zeros((48, npad), dtype=torch.float32, device=state.device)
    geom[:, :n] = rows
    return geom


def hull_obb_prefilter(ga, gb, la: Tensor, lb: Tensor, cap2: int):
    """The hull table's prefilter: the 6 face axes of the two hulls' local
    AABBs as oriented boxes, centred at rows 20:23, on every candidate
    lane; the overlapping lanes with a movable body and two hulls
    compacted, in order, into cap2 lanes. Returns (la, lb, dropped
    [NB])."""
    c = 20
    t = (gb[c] - ga[c], gb[c + 1] - ga[c + 1], gb[c + 2] - ga[c + 2])
    sep_best = _face_sat_sep(
        t, tuple(ga[3 + k] for k in range(9)),
        tuple(gb[3 + k] for k in range(9)),
        (ga[12], ga[13], ga[14]), (gb[12], gb[13], gb[14]))
    keep = ((sep_best < 0.0) & ((ga[17] > 0.0) | (gb[17] > 0.0))
            & (la >= 0))
    keep = keep & (ga[19] > 0.0) & (gb[19] > 0.0)
    return _compact_lanes(keep, la, lb, cap2)


def _round8(x: int) -> int:
    return -(-x // 8) * 8


class HullCoef(NamedTuple):
    """Coefficient tables of one ordered hull-type pair, in the JAX
    kernel's layout (each gains a leading [H²] pair axis when stacked):

    c16 [2·V·FP + 3·D2P + 2·V·D2P, 16] — rows dotted with m_ext:
          A_FACE [v·FP + f], B_FACE [v·FP + f], LAX [c·D2P + a],
          EAV [v·D2P + a], EBV [v·D2P + a]
    c32 [rows, FP] — per reference face: incident alignment INC_RA/INC_RB
          [k·FP + o], polygon coords POLY_A/B [c·E + e], vertex count,
          normal and plane offset per side
    c88 [2·9·V, D2P] — SAV/SBV [k·V + u]: supports on a chosen edge axis
    c48 [4·E2P, V]  — edge-endpoint one-hots S0A, S1A, S0B, S1B
    c80 [16, E2P]   — edge endpoint coords (A: v0 xyz | v1 xyz, then B)
    cb  [rows, 1]   — biases: FBIAS_A/B (+BIG on unused faces),
          EBIAS_A/B (+BIG on unused edges)
    v3c [V, 3] hull-A vertices (stacked: [H·round8(V), 3] per type)
    """

    c16: Tensor
    c32: Tensor
    c88: Tensor
    c48: Tensor
    c80: Tensor
    cb: Tensor
    v3c: Tensor


class HullDims(NamedTuple):
    """Shape constants shared by the tables, the plain version and the
    kernel."""

    f: int        # faces
    fp: int       # padded faces (8-multiple)
    vcap: int     # vertex capacity
    d2: int       # edge-direction pairs D²
    d2p: int      # padded (8-multiple)
    e: int        # max vertices per face (clip slots 2E, slots S = 2E + 1)
    e2: int       # unique edges
    e2p: int


def _c32_offsets(fp: int, e: int):
    inc_ra = 0
    inc_rb = 9 * fp
    poly_a = 18 * fp
    poly_b = poly_a + 3 * e
    fcnt_a = poly_b + 3 * e
    fcnt_b = fcnt_a + 1
    fn_a = fcnt_b + 1
    fn_b = fn_a + 3
    off_a = fn_b + 3
    off_b = off_a + 1
    total = _round8(off_b + 1)
    return (inc_ra, inc_rb, poly_a, poly_b, fcnt_a, fcnt_b, fn_a, fn_b,
            off_a, off_b, total)


def cb_offsets(fp: int, e2p: int):
    """(FBIAS_A, FBIAS_B, EBIAS_A, EBIAS_B) row offsets of cb."""
    return 0, fp, 2 * fp, 2 * fp + e2p


def hull_dims(hulls) -> HullDims:
    f = hulls.face_normals.shape[1]
    vcap = hulls.verts.shape[1]
    d2 = hulls.edge_dirs.shape[1] ** 2
    e = hulls.face_verts.shape[2]
    e2 = hulls.edge_i0.shape[1]
    return HullDims(f=f, fp=_round8(f), vcap=vcap, d2=d2, d2p=_round8(d2),
                    e=e, e2=e2, e2p=_round8(e2))


def _padf(x: Tensor, width: int, dim: int) -> Tensor:
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - dim) + 1] = width - x.shape[dim]
    return torch.nn.functional.pad(x, pad)


def build_hull_coef(hulls, ia: int = 0, ib: int = 0
                    ) -> Tuple[HullCoef, HullDims]:
    """The coefficient tables of hull type pair (ia, ib), in the kernel's
    vertex-major / component-major padded layouts (the JAX package's
    build_hull_coef). Every block is SIDED (A = type ia, B = type ib)."""
    ht = build_hull_tables(hulls, ia, ib)
    dm = hull_dims(hulls)
    f, fp, vcap = dm.f, dm.fp, dm.vcap
    d2, d2p, e, e2p = dm.d2, dm.d2p, dm.e, dm.e2p
    dev = ht.verts_a.device
    f32 = torch.float32
    big = torch.tensor(BIG, dtype=f32, device=dev)

    def face_const(mask, off):
        # unused faces carry -BIG in the constant column, so they never
        # win the separation argmax
        c = torch.where(mask > 0, -off, -big)
        return torch.cat([c, torch.full((fp - f,), -BIG, dtype=f32,
                                        device=dev)])

    const_a = face_const(ht.face_mask_a, ht.face_off_a)
    const_b = face_const(ht.face_mask_b, ht.face_off_b)
    n32a = _padf(ht.face_n_a, fp, 0)
    n32b = _padf(ht.face_n_b, fp, 0)
    zeros3 = torch.zeros((vcap, fp, 3), dtype=f32, device=dev)

    def face_block(coef, nrm, const, dpa_side: bool):
        c9 = _padf(coef.reshape(f, vcap, 9).permute(1, 0, 2), fp, 1)
        nb = nrm[None].expand(vcap, fp, 3)
        cols = [c9, nb, zeros3] if dpa_side else [c9, zeros3, nb]
        cols.append(const[None, :, None].expand(vcap, fp, 1))
        return torch.cat(cols, dim=-1).reshape(vcap * fp, 16)

    def pad16(x):
        return torch.nn.functional.pad(x, (0, 7))

    a_face = face_block(ht.a_fv, n32a, const_a, True)
    b_face = face_block(ht.b_fv, n32b, const_b, False)
    lax = (ht.l_ax.reshape(d2, 3, 9).permute(1, 0, 2)
           * ht.ax_mask[None, :, None])
    lax = pad16(_padf(lax, d2p, 1).reshape(3 * d2p, 9))
    eav = pad16(_padf(ht.c_av.reshape(d2, vcap, 9).permute(1, 0, 2),
                      d2p, 1).reshape(vcap * d2p, 9))
    ebv = pad16(_padf(ht.c_bv.reshape(d2, vcap, 9).permute(1, 0, 2),
                      d2p, 1).reshape(vcap * d2p, 9))
    c16 = torch.cat([a_face, b_face, lax, eav, ebv])

    ff3 = ht.ff.reshape(f, f, 9)                          # [a, b, k]
    inc_ra = _padf(_padf(ff3.permute(2, 1, 0), fp, 1), fp, 2).reshape(
        9 * fp, fp)
    inc_rb = _padf(_padf(ff3.permute(2, 0, 1), fp, 1), fp, 2).reshape(
        9 * fp, fp)

    def poly_block(verts, face_verts, face_cnt, nrm32, off):
        poly = _padf(verts[face_verts.long()].permute(2, 1, 0), fp, 2
                     ).reshape(3 * e, fp)
        fcnt = _padf(face_cnt.to(f32), fp, 0)[None, :]
        offr = _padf(off, fp, 0)[None, :]
        return poly, fcnt, nrm32.T, offr

    pa_, fca, fna, offa = poly_block(ht.verts_a, ht.face_verts_a,
                                     ht.face_cnt_a, n32a, ht.face_off_a)
    pb_, fcb, fnb, offb = poly_block(ht.verts_b, ht.face_verts_b,
                                     ht.face_cnt_b, n32b, ht.face_off_b)
    *_, c32_rows = _c32_offsets(fp, e)
    c32 = torch.cat([inc_ra, inc_rb, pa_, pb_, fca, fcb, fna, fnb, offa,
                     offb])
    c32 = _padf(c32, c32_rows, 0)

    sav = _padf(ht.c_av.reshape(d2, vcap, 9).permute(2, 1, 0), d2p, 2
                ).reshape(9 * vcap, d2p)
    sbv = _padf(ht.c_bv.reshape(d2, vcap, 9).permute(2, 1, 0), d2p, 2
                ).reshape(9 * vcap, d2p)
    c88 = torch.cat([sav, sbv])

    def edge_onehots(i0, i1, emask):
        eye = torch.eye(vcap, dtype=f32, device=dev)
        s0 = _padf(eye[i0.long()] * emask[:, None], e2p, 0)
        s1 = _padf(eye[i1.long()] * emask[:, None], e2p, 0)
        return s0, s1

    s0a, s1a = edge_onehots(ht.edge_i0_a, ht.edge_i1_a, ht.edge_mask_a)
    s0b, s1b = edge_onehots(ht.edge_i0_b, ht.edge_i1_b, ht.edge_mask_b)
    c48 = torch.cat([s0a, s1a, s0b, s1b])
    c48 = _padf(c48, _round8(c48.shape[0]), 0)

    def edge_pts(verts, i0, i1):
        return torch.cat([_padf(verts[i0.long()].T, e2p, 1),
                          _padf(verts[i1.long()].T, e2p, 1)])

    c80 = torch.cat([edge_pts(ht.verts_a, ht.edge_i0_a, ht.edge_i1_a),
                     edge_pts(ht.verts_b, ht.edge_i0_b, ht.edge_i1_b)])
    c80 = _padf(c80, 16, 0)

    def bias(mask, width):
        return torch.where(_padf(mask, width, 0) > 0,
                           torch.zeros((), dtype=f32, device=dev), big)

    cb = torch.cat([bias(ht.face_mask_a, fp), bias(ht.face_mask_b, fp),
                    bias(ht.edge_mask_a, e2p), bias(ht.edge_mask_b, e2p)
                    ])[:, None]
    cb = _padf(cb, _round8(cb.shape[0]), 0)
    return HullCoef(c16=c16, c32=c32, c88=c88, c48=c48, c80=c80, cb=cb,
                    v3c=ht.verts_a), dm


def build_hull_coef_multi(hulls) -> Tuple[HullCoef, HullDims, int]:
    """Every ordered type pair's tables stacked on a leading [H²] axis
    (pair p = ia·H + ib); v3c becomes the per-type vertex stack
    [H·round8(V), 3]."""
    h = hulls.verts.shape[0]
    coefs = []
    dm = None
    for ia in range(h):
        for ib in range(h):
            c, dm = build_hull_coef(hulls, ia, ib)
            coefs.append(c)
    stacked = HullCoef(*[
        torch.stack([getattr(c, name) for c in coefs])
        for name in ("c16", "c32", "c88", "c48", "c80", "cb")
    ] + [None])
    vs = _round8(dm.vcap)
    gv = torch.stack([
        _padf(hulls.verts[t], vs, 0) for t in range(h)
    ]).reshape(h * vs, 3)
    return stacked._replace(v3c=gv), dm, h


class HullTableCoef(NamedTuple):
    """Everything the hull table reads from the hull library, on the
    library's device: the stacked coefficient tables, their shapes, the
    type count, each pair's edge endpoint indices (the one-hot rows of
    c48 as indices, −1 where a row is empty; [H², 4, E2P] int32: A v0,
    A v1, B v0, B v1), and the per-type ground vertex bias [H·round8(V)]
    (0 for a real vertex, −BIG for padding)."""

    coef: HullCoef
    dims: HullDims
    ntypes: int
    eidx: Tensor
    vbias: Tensor


def hull_table_coef(hulls) -> HullTableCoef:
    """The library's table inputs (ops/hull_table._hull_table_coef),
    built once a library and kept on it."""
    got = getattr(hulls, "table_coef", None)
    if got is not None:
        return got
    coef, dm, h = build_hull_coef_multi(hulls)
    c48 = coef.c48[:, :4 * dm.e2p].reshape(h * h, 4, dm.e2p, dm.vcap)
    eidx = torch.where(c48.amax(dim=3) > 0, torch.argmax(c48, dim=3),
                       torch.full_like(c48[..., 0], -1, dtype=torch.int64))
    vs = _round8(dm.vcap)
    vbias = torch.where(
        torch.arange(vs, device=hulls.verts.device)[None, :]
        < hulls.vert_count[:, None], 0.0, -BIG).reshape(h * vs)
    hulls.table_coef = HullTableCoef(
        coef, dm, h, eidx.to(torch.int32).contiguous(),
        vbias.to(torch.float32).contiguous())
    return hulls.table_coef


def _argmax0(x: Tensor):
    """(max, index of its FIRST occurrence) over dim 0."""
    return torch.amax(x, dim=0), torch.argmax(x, dim=0)


def _lin16(rows: Tensor, mext) -> Tensor:
    """rows [R, 16] dotted with m_ext (16 × [NB, L]) → [R, NB, L], summed
    left to right."""
    acc = rows[:, 0, None, None] * mext[0]
    for k in range(1, 16):
        acc = acc + rows[:, k, None, None] * mext[k]
    return acc


def _lin9(blk: Tensor, m9) -> Tensor:
    """blk [9, ...] · m9 summed over k left to right."""
    acc = blk[0] * m9[0]
    for k in range(1, 9):
        acc = acc + blk[k] * m9[k]
    return acc


def _sat_pass(tc: HullTableCoef, p: int, ga, gb, m9, dpa, mext):
    """One ordered type pair's SAT, clip and edge-edge contact over all
    lanes [NB, L]. Returns the per-lane manifold pieces."""
    dm = tc.dims
    fp, vcap, d2p, e, e2p = dm.fp, dm.vcap, dm.d2p, dm.e, dm.e2p
    c16, c32 = tc.coef.c16[p], tc.coef.c32[p]
    c88, c80 = tc.coef.c88[p], tc.coef.c80[p]
    cb, eidx = tc.coef.cb[p][:, 0], tc.eidx[p].long()
    a_face, b_face = 0, vcap * fp
    lax = 2 * vcap * fp
    eav = lax + 3 * d2p
    ebv = eav + vcap * d2p
    (inc_ra, inc_rb, poly_a, poly_b, fcnt_a, fcnt_b, fn_a, fn_b, off_a,
     off_b, _) = _c32_offsets(fp, e)
    fb_a, fb_b, eb_a, eb_b = cb_offsets(fp, e2p)
    lane_shape = m9[0].shape
    ra = tuple(ga[3 + k] for k in range(9))
    rb = tuple(gb[3 + k] for k in range(9))
    pa3 = (ga[0], ga[1], ga[2])
    pb3 = (gb[0], gb[1], gb[2])

    # ---- face and edge separations (linear SAT) ----
    sep_a = _lin16(c16[a_face:b_face], mext).reshape(
        vcap, fp, *lane_shape).amin(0)
    sep_b = _lin16(c16[b_face:lax], mext).reshape(
        vcap, fp, *lane_shape).amin(0)
    axes = _lin16(c16[lax:eav], mext).reshape(3, d2p, *lane_shape)
    ax0, ax1, ax2c = axes[0], axes[1], axes[2]
    ax_sq = ax0 * ax0 + ax1 * ax1 + ax2c * ax2c
    alen = torch.sqrt(torch.clamp(ax_sq, min=1e-18))
    t_ax = -(ax0 * dpa[0] + ax1 * dpa[1] + ax2c * dpa[2])
    sa_all = _lin16(c16[eav:ebv], mext).reshape(vcap, d2p, *lane_shape)
    sb_all = _lin16(c16[ebv:ebv + vcap * d2p], mext).reshape(
        vcap, d2p, *lane_shape)
    min_a, max_a = sa_all.amin(0), sa_all.amax(0)
    min_b, max_b = sb_all.amin(0), sb_all.amax(0)
    flip = t_ax < 0.0
    sep_num = torch.where(flip, min_b - max_a - t_ax, min_a - max_b + t_ax)
    sep_e = torch.where(alen > 1e-6, sep_num / alen,
                        torch.full_like(alen, -BIG))

    # ---- axis choice ----
    face_sep_v, bf = _argmax0(torch.cat([sep_a, sep_b]))
    edge_sep, ae = _argmax0(sep_e)
    separated = torch.maximum(face_sep_v, edge_sep) > 0.0
    edge_wins = (~separated) & (
        edge_sep > face_sep_v + 1e-4 + 0.05 * torch.abs(face_sep_v))
    ref_is_a = bf < fp
    fr = torch.where(ref_is_a, bf, bf - fp)

    # ---- incident face: most anti-parallel face of the other hull ----
    ce_a = c32[inc_ra:inc_ra + 9 * fp].reshape(9, fp, fp)[:, :, fr]
    ce_b = c32[inc_rb:inc_rb + 9 * fp].reshape(9, fp, fp)[:, :, fr]
    al = _lin9(torch.where(ref_is_a, ce_a, ce_b), m9)       # [FP, NB, L]
    fbias = torch.where(ref_is_a, cb[fb_b:fb_b + fp, None, None],
                        cb[fb_a:fb_a + fp, None, None])
    _, fi = _argmax0(-(al + fbias))

    # ---- face polygons (owner frame) → world ----
    ref_loc = torch.where(ref_is_a, c32[poly_a:poly_a + 3 * e, fr],
                          c32[poly_b:poly_b + 3 * e, fr])
    inc_loc = torch.where(ref_is_a, c32[poly_b:poly_b + 3 * e, fi],
                          c32[poly_a:poly_a + 3 * e, fi])
    ref_cnt = torch.where(ref_is_a, c32[fcnt_a, fr],
                          c32[fcnt_b, fr]).to(torch.int32)
    inc_cnt = torch.where(ref_is_a, c32[fcnt_b, fi],
                          c32[fcnt_a, fi]).to(torch.int32)
    r_ref = tuple(torch.where(ref_is_a, ra[k], rb[k]) for k in range(9))
    r_inc = tuple(torch.where(ref_is_a, rb[k], ra[k]) for k in range(9))
    p_ref = v3.where(ref_is_a, pa3, pb3)
    p_inc = v3.where(ref_is_a, pb3, pa3)

    def to_world(loc, r, t):
        out = []
        for k in range(e):
            x, y, z = loc[k], loc[e + k], loc[2 * e + k]
            out.append((r[0] * x + r[1] * y + r[2] * z + t[0],
                        r[3] * x + r[4] * y + r[5] * z + t[1],
                        r[6] * x + r[7] * y + r[8] * z + t[2]))
        return out

    ref_w = to_world(ref_loc, r_ref, p_ref)
    inc_w = to_world(inc_loc, r_inc, p_inc)
    nloc = torch.where(ref_is_a, c32[fn_a:fn_a + 3, fr],
                       c32[fn_b:fn_b + 3, fr])
    n_ref = v3.mat_vec(r_ref, (nloc[0], nloc[1], nloc[2]))
    off_sel = torch.where(ref_is_a, c32[off_a, fr], c32[off_b, fr])
    off_ref = off_sel + v3.dot(n_ref, p_ref)

    # ---- 2-D clip in the reference-face frame ----
    edge0 = v3.sub(ref_w[1], ref_w[0])
    t1 = v3.scale(edge0, 1.0 / torch.clamp(v3.norm(edge0), min=1e-9))
    t2 = v3.cross(n_ref, t1)
    p0 = ref_w[0]
    ru, rv = [], []
    for k in range(e):
        rel = v3.sub(ref_w[k], p0)
        ru.append(v3.dot(rel, t1))
        rv.append(v3.dot(rel, t2))
    zero = torch.zeros_like(m9[0])
    iu, iv, is_ = [], [], []
    for k in range(e):
        rel = v3.sub(inc_w[k], p0)
        iu.append(v3.dot(rel, t1))
        iv.append(v3.dot(rel, t2))
        is_.append(v3.dot(inc_w[k], n_ref) - off_ref)
    pu = torch.stack(iu + [zero] * e)
    pv = torch.stack(iv + [zero] * e)
    ps = torch.stack(is_ + [zero] * e)
    m_cnt = inc_cnt
    for k in range(e):
        if k + 1 < e:
            wrapped = (k + 1) == ref_cnt
            ru_n = torch.where(wrapped, ru[0], ru[k + 1])
            rv_n = torch.where(wrapped, rv[0], rv[k + 1])
        else:
            ru_n, rv_n = ru[0], rv[0]
        e_u = ru_n - ru[k]
        e_v = rv_n - rv[k]
        on = (k < ref_cnt).to(torch.float32)
        pu, pv, ps, m_cnt = _clip(
            pu, pv, ps, m_cnt, e_v * on, -e_u * on,
            (e_v * ru[k] - e_u * rv[k]) * on + (1.0 - on) * BIG)
    n_face = v3.where(ref_is_a, v3.neg(n_ref), n_ref)

    # ---- edge-edge closest-point contact ----
    def at_axis(x):
        return torch.gather(x, 0, ae[None])[0]

    sgn = torch.where(at_axis(flip), -1.0, 1.0)
    ax_u = v3.scale((at_axis(ax0), at_axis(ax1), at_axis(ax2c)),
                    sgn / torch.clamp(at_axis(alen), min=1e-9))
    n_edge = v3.mat_vec(ra, ax_u)

    def edge_scores(base, i0_row, i1_row, combine):
        blk = c88[base:base + 9 * vcap].reshape(9, vcap, d2p)[:, :, ae]
        s = torch.cat([_lin9(blk, m9) * sgn, zero[None]])   # [V + 1, ...]
        i0 = torch.where(eidx[i0_row] >= 0, eidx[i0_row], vcap)
        i1 = torch.where(eidx[i1_row] >= 0, eidx[i1_row], vcap)
        return combine(s[i0], s[i1])

    score_a = edge_scores(0, 0, 1, torch.maximum) + cb[eb_a:eb_a + e2p,
                                                         None, None]
    score_b = edge_scores(9 * vcap, 2, 3, torch.minimum) - cb[
        eb_b:eb_b + e2p, None, None]
    _, ea = _argmax0(-score_a)
    _, eb = _argmax0(score_b)
    epa = c80[0:6, ea]
    epb = c80[6:12, eb]
    ea0 = v3.add(v3.mat_vec(ra, (epa[0], epa[1], epa[2])), pa3)
    ea1 = v3.add(v3.mat_vec(ra, (epa[3], epa[4], epa[5])), pa3)
    eb0 = v3.add(v3.mat_vec(rb, (epb[0], epb[1], epb[2])), pb3)
    eb1 = v3.add(v3.mat_vec(rb, (epb[3], epb[4], epb[5])), pb3)
    d1 = v3.sub(ea1, ea0)
    d2v = v3.sub(eb1, eb0)
    r0v = v3.sub(ea0, eb0)
    a11 = v3.dot(d1, d1)
    a22 = v3.dot(d2v, d2v)
    a12 = v3.dot(d1, d2v)
    b1 = v3.dot(d1, r0v)
    b2 = v3.dot(d2v, r0v)
    den = a11 * a22 - a12 * a12
    sparm = torch.where(torch.abs(den) > 1e-9, (a12 * b2 - a22 * b1) / den,
                        zero)
    sparm = torch.clamp(sparm, 0.0, 1.0)
    tparm = torch.where(a22 > 1e-9, (b2 + a12 * sparm) / a22, zero)
    tparm = torch.clamp(tparm, 0.0, 1.0)
    sparm = torch.where(a11 > 1e-9,
                        torch.clamp((a12 * tparm - b1) / a11, 0.0, 1.0),
                        sparm)
    pa_c = v3.add(ea0, v3.scale(d1, sparm))
    pb_c = v3.add(eb0, v3.scale(d2v, tparm))
    edge_point = v3.scale(v3.add(pa_c, pb_c), 0.5)
    return dict(ps=ps, pu=pu, pv=pv, m_cnt=m_cnt, n_face=n_face, p0=p0,
                t1=t1, t2=t2, n_ref=n_ref, separated=separated,
                edge_wins=edge_wins, edge_point=edge_point,
                edge_depth=-edge_sep, n_edge=n_edge)


def _select_pass(outs, pair):
    """Per lane, the pass of its own ordered type pair."""
    if len(outs) == 1:
        return outs[0]

    def pick(vals):
        acc = vals[0]
        for p in range(1, len(vals)):
            if isinstance(acc, tuple):
                acc = v3.where(pair == p, vals[p], acc)
            else:
                m = pair == p
                acc = torch.where(m if acc.dim() == m.dim() else m[None],
                                  vals[p], acc)
        return acc

    return {k: pick([o[k] for o in outs]) for k in outs[0]}


def bucket_hull_contact_table_plain(geom, la, lb, pcols, tc: HullTableCoef,
                                    *, ccap, kk, kg, cap2, ground_height,
                                    anchors, bucket0=0):
    """Plain version of the hull table kernel, all buckets at once, on the
    kernel's operands: geom [48, NPAD] in hull mode, la/lb [NB, cap] int32
    window-local candidate ranks (−1 = empty lane) of the NB buckets from
    bucket0 on, pcols [NB·ccap, 8]
    previous-step key columns or None, the library's coefficient tables.
    Returns (table [rows, NB·ccap], meta [8, NB·128], warm [8, NB·ccap]
    or None)."""
    dev = geom.device
    f32 = torch.float32
    nb, cap = la.shape
    dm = tc.dims
    e, vcap = dm.e, dm.vcap
    cap_sl = 2 * e
    rows_n = CT2_ROWS if anchors else CT_ROWS
    win = geom[24:48]
    start = _bucket_starts(nb, bucket0, dev)

    ga, gb = lane_geometry(geom, la, bucket0), lane_geometry(geom, lb,
                                                             bucket0)
    dropped2 = torch.zeros((nb,), dtype=torch.int64, device=dev)
    if cap2:
        la, lb, dropped2 = hull_obb_prefilter(ga, gb, la, lb, cap2)
        ga, gb = lane_geometry(geom, la, bucket0), lane_geometry(
            geom, lb, bucket0)

    valid = ((la >= 0) & ((ga[17] > 0.0) | (gb[17] > 0.0))
             & (ga[19] > 0.0) & (gb[19] > 0.0))
    ra = tuple(ga[3 + k] for k in range(9))
    rb = tuple(gb[3 + k] for k in range(9))
    m9 = [ra[i] * rb[j] + ra[3 + i] * rb[3 + j] + ra[6 + i] * rb[6 + j]
          for i in range(3) for j in range(3)]
    dp = (gb[0] - ga[0], gb[1] - ga[1], gb[2] - ga[2])
    dpa = tuple(ra[i] * dp[0] + ra[3 + i] * dp[1] + ra[6 + i] * dp[2]
                for i in range(3))
    dpb = tuple(-(rb[i] * dp[0] + rb[3 + i] * dp[1] + rb[6 + i] * dp[2])
                for i in range(3))
    mext = m9 + list(dpa) + list(dpb) + [torch.ones_like(m9[0])]

    h = tc.ntypes
    pair = ((ga[19] - 1.0).to(torch.int64) * h
            + (gb[19] - 1.0).to(torch.int64))
    outs = [_sat_pass(tc, p, ga, gb, m9, dpa, mext) for p in range(h * h)]
    sp = _select_pass(outs, pair)

    # ---- slot scores + top-k emit ----
    face_ok = valid & ~sp["separated"] & ~sp["edge_wins"]
    big_neg = torch.full_like(m9[0], -BIG)
    d_rows = -sp["ps"]
    score = [torch.where((s < sp["m_cnt"]) & (d_rows[s] > 0.0) & face_ok,
                         d_rows[s], big_neg) for s in range(cap_sl)]
    edge_ok = valid & sp["edge_wins"] & (sp["edge_depth"] > 0.0)
    score.append(torch.where(edge_ok, sp["edge_depth"], big_neg))
    zero = torch.zeros_like(m9[0])
    pu_rows = [sp["pu"][s] for s in range(cap_sl)] + [zero]
    pv_rows = [sp["pv"][s] for s in range(cap_sl)] + [zero]
    ps_rows = [sp["ps"][s] for s in range(cap_sl)] + [zero]
    p0, t1, t2, n_ref = sp["p0"], sp["t1"], sp["t2"], sp["n_ref"]

    mu_p = torch.sqrt(ga[15] * gb[15])
    rest_p = torch.maximum(ga[16], gb[16])
    ia = ga[18].to(torch.int32)
    ib = gb[18].to(torch.int32)
    kl_p = torch.maximum(ia, ib).to(f32)
    kh_p = torch.minimum(ia, ib).to(f32)
    live = (la >= 0).to(f32)
    ra_p = (start + la).to(f32) * live
    rb1_p = (start + lb + 1).to(f32) * live

    rows = [[] for _ in range(rows_n)]

    def emit(vals, act, anc):
        af = act.to(f32)
        vals = vals[:9] + [af] + [v * af for v in vals[9:]]
        if anchors:
            vals += [v * af for v in anc]
            vals += [torch.zeros_like(af)] * (CT2_ROWS - 25)
        for r, v in enumerate(vals):
            rows[r].append(v)

    for _ in range(kk):
        best, bidx = _argmax_unrolled(score)
        act = best > 0.0
        is_edge = bidx == cap_sl
        u_sel = _select(bidx, pu_rows)
        v_sel = _select(bidx, pv_rows)
        s_sel = _select(bidx, ps_rows)
        face_pt = tuple(p0[c] + u_sel * t1[c] + v_sel * t2[c]
                        + s_sel * n_ref[c] for c in range(3))
        pt = v3.where(is_edge, sp["edge_point"], face_pt)
        nrm = v3.where(is_edge, sp["n_edge"], sp["n_face"])
        anc = None
        if anchors:
            anc = (list(_t_apply(ga, v3.sub(pt, (ga[0], ga[1], ga[2]))))
                   + list(_t_apply(gb, v3.sub(pt, (gb[0], gb[1], gb[2]))))
                   + list(_t_apply(ga, nrm)))
        emit([pt[0], pt[1], pt[2], nrm[0], nrm[1], nrm[2],
              torch.where(act, best, zero), mu_p, rest_p, kl_p, kh_p,
              zero, ra_p, rb1_p, bidx.to(f32)], act, anc)
        score = [torch.where(bidx == s, big_neg, score[s])
                 for s in range(cap_sl + 1)]

    # ---- vertex ground contacts for the bucket's own 128 ranks ----
    if kg > 0:
        gl = win[:, start[:, 0, None] + torch.arange(BLOCK, device=dev)]
        vs = _round8(vcap)
        typef = gl[19]
        tok = (typef > 0.5) & (typef < h + 0.5)
        tq = torch.clamp(torch.round(typef).to(torch.int64) - 1, 0, h - 1)
        vrow = tq[None] * vs + torch.arange(vcap, device=dev)[:, None, None]
        gv = tc.coef.v3c
        zg = torch.zeros_like(gl[0])
        lv = [torch.where(tok[None], gv[vrow, c], zg) for c in range(3)]
        vbl = torch.where(tok[None], tc.vbias[vrow], zg)     # [V, NB, 128]
        wy = lv[0] * gl[6] + lv[1] * gl[7] + lv[2] * gl[8]
        wy = wy + gl[1]
        depth_g = ground_height - wy
        gsc = torch.where((gl[17] > 0.0)[None] & (depth_g > 0.0),
                          depth_g + vbl, torch.full_like(depth_g, -BIG))
        ra_g = (start + torch.arange(BLOCK, device=dev)).to(f32)
        one_g = torch.ones_like(zg)
        vi = torch.arange(vcap, device=dev)[:, None, None]
        for _ in range(kg):
            bestg, vidx = _argmax0(gsc)
            act = bestg > 0.0
            lx, ly, lz = (torch.gather(x, 0, vidx[None])[0] for x in lv)
            cx = gl[0] + gl[3] * lx + gl[4] * ly + gl[5] * lz
            cy = gl[1] + gl[6] * lx + gl[7] * ly + gl[8] * lz
            cz = gl[2] + gl[9] * lx + gl[10] * ly + gl[11] * lz
            anc = [lx, ly, lz, cx, cy, cz, gl[6], gl[7], gl[8]]
            emit([cx, cy, cz, zg, one_g, zg, torch.where(act, bestg, zg),
                  gl[15], gl[16], gl[18], zg, one_g, ra_g, zg,
                  vidx.to(f32)], act, anc)
            gsc = torch.where(vi == vidx[None], -BIG, gsc)

    return compact_emissions(rows, ccap, dropped2, pcols)


def hull_operands(state: State, cand: PairCandidates, cfg: Config,
                  prev, geom: Tensor):
    """The table's operands (ops/hull_table._prepare): (la, lb, pcols,
    coefficient tables, keywords)."""
    la, lb, pcols, kw = table_operands(state, cand, cfg, prev, geom,
                                       "hull table")
    del kw["nb"], kw["bp"]
    tc = hull_table_coef(state.hulls)
    dm = tc.dims
    kw["kk"] = min(cfg.max_contacts_per_pair, 2 * dm.e + 1)
    kw["kg"] = (min(cfg.max_contacts_per_pair, 8, dm.vcap)
                if cfg.ground_plane else 0)
    return la, lb, pcols, tc, kw
