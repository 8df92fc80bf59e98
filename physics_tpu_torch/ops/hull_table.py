"""Fused bucket-aligned HULL contact table: CUDA kernel and its plain
PyTorch version (physics_tpu/ops/hull_table.py).

The hulls-only analogue of ops/contact_table.py, with its bucket contract
(output rows, meta columns, warm rows, emission order). For each bucket of
128 sweep ranks:
  1. the OBB face-axis prefilter over the bucket's candidate lanes, the
     survivors compacted in order into `bucket_cap2` lanes;
  2. per surviving lane the hull-hull SAT of its ordered hull-type pair:
     face and edge-edge separations in the LINEAR form — each one a
     16-term dot of a coefficient row with the pair's
     m_ext = [R_aᵀR_b | dpa | dpb | 1], min-reduced over vertex groups
     (ops/hullhull_batched.py) — then the axis choice, the incident face,
     a Sutherland–Hodgman clip of it against the reference face, the
     edge-edge closest point, and the `kk` deepest of the 2E + 1 slots;
  3. the `kg` lowest hull vertices of each of the bucket's own ranks
     below the ground plane;
  4. compaction of the emissions (pick-major over the pair lanes, then
     pick-major over the ranks) into `ccap` slots, the meta counters and
     the warm-start match (ops/contact_table.compact_emissions).

Replaces the TPU kernel `bucket_hull_contact_table`
(physics_tpu/ops/hull_table.py:1092, call :1218, body `_make_hull_kernel`
:373-1084). That kernel selected every per-lane quantity with one-hot
matmuls, moved data through hi/lo bf16 splits and made one masked pass
per ordered type pair; here those are indexed reads, and the kernel's
SAT makes one pass per ordered type pair present among a block's lanes,
its coefficient rows staged in shared memory (csrc/hull_table.cu). The
16-term dots are summed left to right, elementwise, in the plain version
and the kernel alike (nvcc -fmad=false), so the two agree bit for bit;
against the TPU
kernel, which contracts with matmuls and carries payloads through the
bf16 split, the f32 rows differ by about 2⁻¹⁷ of each value.

The coefficient tables depend only on the hull library, so they are
built once per HullSet (`hull_table_coef`), not once per call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from physics_tpu_torch import tracing
from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops.boxbox_batched import _argmax_unrolled, _clip, _select
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.ops.contact_table import (
    BLOCK,
    CT2_ROWS,
    CT_ROWS,
    _bucket_starts,
    _t_apply,
    compact_emissions,
    lane_geometry,
    obb_prefilter,
    table_operands,
)
from physics_tpu_torch.ops.hullhull_batched import hull_tables
from physics_tpu_torch.state import SimState

Tensor = torch.Tensor

# the table path takes hull libraries of at most this many types (the
# JAX kernel makes one SAT pass per ordered type pair)
MAX_TABLE_HULL_TYPES = 3
BIG = 1e30
_KS_LIMIT = 128   # slot / vertex ids must stay < 128 (f32-exact warm keys)


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
    e2p: int      # padded (8-multiple)


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


def hull_slots(hulls) -> int:
    """Contact slots per pair (2E face-clip slots + 1 edge)."""
    return 2 * hulls.face_verts.shape[2] + 1


def _padf(x: Tensor, width: int, dim: int) -> Tensor:
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - dim) + 1] = width - x.shape[dim]
    return torch.nn.functional.pad(x, pad)


def build_hull_coef(state: SimState, ia: int = 0, ib: int = 0
                    ) -> Tuple[HullCoef, HullDims]:
    """The coefficient tables of hull type pair (ia, ib), in the kernel's
    vertex-major / component-major padded layouts (the JAX package's
    build_hull_coef). Every block is SIDED (A = type ia, B = type ib)."""
    ht = hull_tables(state.hulls, ia, ib)
    dm = hull_dims(state.hulls)
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


def build_hull_coef_multi(state: SimState
                          ) -> Tuple[HullCoef, HullDims, int]:
    """Every ordered type pair's tables stacked on a leading [H²] axis
    (pair p = ia·H + ib); v3c becomes the per-type vertex stack
    [H·round8(V), 3]."""
    h = state.hulls.verts.shape[0]
    coefs = []
    dm = None
    for ia in range(h):
        for ib in range(h):
            c, dm = build_hull_coef(state, ia, ib)
            coefs.append(c)
    stacked = HullCoef(*[
        torch.stack([getattr(c, name) for c in coefs])
        for name in ("c16", "c32", "c88", "c48", "c80", "cb")
    ] + [None])
    vs = _round8(dm.vcap)
    gv = torch.stack([
        _padf(state.hulls.verts[t], vs, 0) for t in range(h)
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


def hull_table_coef(state: SimState) -> HullTableCoef:
    """The hull library's table inputs, kept on the HullSet
    (HullSet.derived), so states stepped from one scene, which share
    their HullSet, build them once, and an edited library builds them
    again."""
    return state.hulls.derived("hull_table_coef",
                               lambda: _hull_table_coef(state))


def _hull_table_coef(state: SimState) -> HullTableCoef:
    hulls = state.hulls
    coef, dm, h = build_hull_coef_multi(state)
    c48 = coef.c48[:, :4 * dm.e2p].reshape(h * h, 4, dm.e2p, dm.vcap)
    eidx = torch.where(c48.amax(dim=3) > 0, torch.argmax(c48, dim=3),
                       torch.full_like(c48[..., 0], -1, dtype=torch.int64))
    vs = _round8(dm.vcap)
    vbias = torch.where(
        torch.arange(vs, device=hulls.verts.device)[None, :]
        < hulls.vert_count[:, None], 0.0, -BIG).reshape(h * vs)
    return HullTableCoef(coef, dm, h, eidx.to(torch.int32).contiguous(),
                         vbias.to(torch.float32).contiguous())


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

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
        la, lb, dropped2 = obb_prefilter(ga, gb, la, lb, cap2, hulls=True)
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
    sink = tracing.slots("hull_sat_lanes", 2)
    if sink is not None:
        sink.add_(torch.stack([valid.sum(),
                               (valid & ~sp["separated"]).sum()]))

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


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _launch_kernel(geom, la, lb, pcols, tc: HullTableCoef, *, ccap, kk, kg,
                   cap2, ground_height, anchors, bucket0):
    from physics_tpu_torch import _build

    dev = geom.device
    nb, cap = la.shape
    npad = geom.shape[1]
    rows_n = CT2_ROWS if anchors else CT_ROWS
    cp = nb * ccap
    dm = tc.dims
    c = tc.coef
    checks = [("geom", geom, torch.float32), ("la", la, torch.int32),
              ("lb", lb, torch.int32), ("c16", c.c16, torch.float32),
              ("c32", c.c32, torch.float32), ("c88", c.c88, torch.float32),
              ("c80", c.c80, torch.float32), ("cb", c.cb, torch.float32),
              ("eidx", tc.eidx, torch.int32), ("v3c", c.v3c, torch.float32),
              ("vbias", tc.vbias, torch.float32)]
    if pcols is not None:
        checks.append(("prev cols", pcols, torch.float32))
    for name, t, dt in checks:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"hull table: {name} must be a contiguous {dt} "
                             f"tensor on {dev}")
    if geom.shape[0] != 48 or lb.shape != la.shape:
        raise ValueError("hull table: geom [48, NPAD], la/lb [NB, cap]")
    # the last bucket of the range reads ranks up to its start + 2·128
    if npad < (bucket0 + nb) * BLOCK + 2 * BLOCK:
        raise ValueError(f"hull table: NPAD {npad} too small for "
                         f"{bucket0 + nb} buckets")
    if pcols is not None and pcols.shape != (cp, 8):
        raise ValueError(f"hull table: prev cols must be [{cp}, 8]")
    lib = _build.library()
    words = lib.ht_scratch_words(nb, cap2 if cap2 else cap, kk, kg, ccap,
                                 dm.fp, dm.d2)
    if words < 0:
        raise ValueError(f"hull table: {nb} buckets of {cap} lanes need "
                         f"more than 2³¹ words of scratch")
    f32 = torch.float32
    table = torch.empty((rows_n, cp), dtype=f32, device=dev)
    meta = torch.empty((8, nb * BLOCK), dtype=f32, device=dev)
    warm = (torch.empty((8, cp), dtype=f32, device=dev)
            if pcols is not None else None)
    # lanes, SAT splits, emissions, slots, warm keys: the kernels write
    # every word before they read it
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    sink = tracing.slots("hull_sat_lanes", 2)
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.ht_bucket_hull_contact_table(
            ptr(geom.data_ptr()), ptr(la.data_ptr()), ptr(lb.data_ptr()),
            ptr(pcols.data_ptr() if pcols is not None else 0),
            ptr(c.c16.data_ptr()), ptr(c.c32.data_ptr()),
            ptr(c.c88.data_ptr()), ptr(c.c80.data_ptr()),
            ptr(c.cb.data_ptr()), ptr(tc.eidx.data_ptr()),
            ptr(c.v3c.data_ptr()), ptr(tc.vbias.data_ptr()),
            ptr(table.data_ptr()), ptr(meta.data_ptr()),
            ptr(warm.data_ptr() if warm is not None else 0),
            ptr(scratch.data_ptr()), scratch.numel(),
            nb, bucket0, cap, cap2, ccap, kk, kg, npad, rows_n, tc.ntypes,
            dm.fp, dm.vcap, dm.e, dm.d2, dm.d2p, dm.e2p,
            c.c16.shape[1], c.c32.shape[1], c.cb.shape[1],
            ctypes.c_float(ground_height),
            ptr(sink.data_ptr() if sink is not None else 0),
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "ht_bucket_hull_contact_table")
    bucket_hull_contact_table.launches += 1
    return table, meta, warm


def _prepare(state: SimState, cand: PairCandidates, cfg: SimConfig,
             prev, geom, buckets=None, plain=False):
    """The wrapper's and the plain version's operands: (la, lb, pcols,
    coefficient tables, keywords)."""
    if state.hulls.verts.shape[0] > MAX_TABLE_HULL_TYPES:
        raise ValueError(
            f"hull table: at most {MAX_TABLE_HULL_TYPES} hull types (larger "
            f"libraries take the generic narrow phase, ROADMAP item 1.13)")
    if cand is None:
        raise ValueError("hull table: needs the bucketed sweep's candidates "
                         "(the in-kernel broad phase is the box table's)")
    la, lb, pcols, kw = table_operands(state, cand, cfg, prev, geom,
                                       "hull table", buckets, plain)
    del kw["nb"], kw["bp"]
    tc = hull_table_coef(state)
    dm = tc.dims
    # the reference's limits, which both versions share (csrc/hull_table.cu
    # is built for faces of up to 64 vertices)
    if 2 * dm.e + 1 > _KS_LIMIT or dm.vcap > _KS_LIMIT:
        raise ValueError("hull table: slot/vertex ids exceed the key range")
    kw["kk"] = min(cfg.max_contacts_per_pair, 2 * dm.e + 1)
    kw["kg"] = (min(cfg.max_contacts_per_pair, 8, dm.vcap)
                if cfg.ground_plane else 0)
    return la, lb, pcols, tc, kw


def bucket_hull_contact_table(
    state: SimState,
    cand: PairCandidates,
    cfg: SimConfig,
    prev: Tuple[Tensor, Tensor] | None = None,
    geom: Tensor | None = None,
    plain: bool = False,
    buckets: Tuple[int, int] | None = None,
) -> Tuple[Tensor, Tensor, Tensor | None]:
    """The hull contact table of one rebuild, with the box table's
    contract (ops/contact_table.bucket_contact_table): returns (table
    [CT_ROWS or CT2_ROWS, NB·ccap], meta [8, NB·128] — per bucket
    dropped contacts / active contacts / prefilter survivors dropped
    beyond bucket_cap2 — and warm [8, NB·ccap] | None). `geom` is the
    unified geometry table in hull mode (unified_geom(..., hulls=True)).
    `buckets = (bucket0, NB)` builds those NB buckets only, with the box
    table's contract.

    While tracing is on inside tracing.counting, both versions add the
    lanes the SAT evaluates and those whose SAT finds the hulls
    overlapping to the counters hull_sat_lanes and hull_sat_pass
    (tracing.slots); otherwise they count nothing.

    A CPU tensor (or `plain=True`) runs the plain version; a CUDA tensor
    launches csrc/hull_table.cu.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    la, lb, pcols, tc, kw = _prepare(state, cand, cfg, prev, geom, buckets,
                                     plain)
    if plain or geom.device.type == "cpu":
        return bucket_hull_contact_table_plain(geom, la, lb, pcols, tc, **kw)
    if geom.device.type != "cuda":
        raise ValueError(f"hull table: unsupported device {geom.device}")
    return _launch_kernel(geom, la, lb, pcols, tc, **kw)


bucket_hull_contact_table.launches = 0
