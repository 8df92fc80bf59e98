"""The fused banded solve of the contact table, plain PyTorch: a frozen
copy of the port's solver/banded_solve.py plain version of the fused
solve (the sweep-0 constants, the projected Jacobi sweeps with split
impulses, the integration epilogue) and of solve_impulses_table on the
fused path.

Projected Jacobi with split impulses on a packed velocity table
z [16, NPAD] in sweep-rank order (rows 0:3 v, 3:6 ω, 8:11 pseudo v, 11:14
pseudo ω, 14 contact degree). Sweep 0 scatters the endpoint degrees and
applies the warm-start impulses; sweeps 1..S each read a snapshot of z
and add every contact's impulse deltas, relaxed by 1/degree and
Coulomb-clamped; the epilogue integrates pos/quat from the final z.
The deltas are summed with index_add, in an order that is not the
port's kernel's (atomics): results agree to rounding.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import vec as v3
from portbench.reference.table import (
    CT_ACT,
    CT_D,
    geom_pad,
    table_keys,
    table_shape,
)

Tensor = torch.Tensor

# consts rows ([R_CONST, Cp])
_R_RA, _R_RB, _R_N, _R_T1, _R_T2 = 0, 3, 6, 9, 12
_R_IKN, _R_IKT1, _R_IKT2, _R_VTGT, _R_BIAS = 15, 16, 17, 18, 19
_R_FRIC, _R_RELAX, _R_IMA, _R_IMB, _R_IWA, _R_IWB = 20, 21, 22, 23, 24, 33
_R_LAM0 = 42
R_SWEEP = 42     # rows a later sweep reads (no λ₀)
R_PREP = 45      # rows the constants math fills (2.6's output)
R_CONST = 48     # + depth and endpoint ranks in the fused solve's scratch
CIN_ROWS = 14
Z_ROWS = 16


def _prep_consts_math(ga, gb, p, nrm, depth, fric, rest, actf, lam0,
                      has_bf, *, baum_over_dt, slop, relaxation, use_split):
    """Per-contact solve constants (the TPU kernel's sweep-0 prep). ga/gb
    are [24, C] endpoint gathers of the geometry table's solve block; the
    rest are [C] contact fields. Returns the list of 45 constant rows."""
    inv_m_a = ga[12] * actf
    inv_m_b = gb[12] * has_bf
    iw_a = tuple(ga[3 + k] * actf for k in range(9))
    iw_b = tuple(gb[3 + k] * has_bf for k in range(9))
    r_a = v3.sub(p, (ga[0], ga[1], ga[2]))
    r_b = v3.sub(p, (gb[0], gb[1], gb[2]))

    ax, ay, az = torch.abs(nrm[0]), torch.abs(nrm[1]), torch.abs(nrm[2])
    use_x = (ax <= ay) & (ax <= az)
    use_y = (~use_x) & (ay <= az)
    f = lambda m: m.to(torch.float32)  # noqa: E731
    e = (f(use_x), f(use_y), f(~(use_x | use_y)))
    t1 = v3.cross(nrm, e)
    t1 = v3.scale(t1, 1.0 / torch.clamp(v3.norm(t1), min=1e-9))
    t2 = v3.cross(nrm, t1)

    def eff_mass(d):
        term_a = v3.dot(d, v3.cross(v3.mat_vec(iw_a, v3.cross(r_a, d)), r_a))
        term_b = v3.dot(d, v3.cross(v3.mat_vec(iw_b, v3.cross(r_b, d)), r_b))
        return inv_m_a + inv_m_b + term_a + term_b

    inv_k_n = 1.0 / torch.clamp(eff_mass(nrm), min=1e-9)
    inv_k_t1 = 1.0 / torch.clamp(eff_mass(t1), min=1e-9)
    inv_k_t2 = 1.0 / torch.clamp(eff_mass(t2), min=1e-9)

    va0 = v3.add((ga[13], ga[14], ga[15]),
                 v3.cross((ga[16], ga[17], ga[18]), r_a))
    vb0 = v3.scale(v3.add((gb[13], gb[14], gb[15]),
                          v3.cross((gb[16], gb[17], gb[18]), r_b)), has_bf)
    v_n0 = v3.dot(nrm, v3.sub(va0, vb0))
    bias = baum_over_dt * torch.clamp(depth - slop, min=0.0)
    bounce = rest * torch.clamp(-v_n0, min=0.0)
    v_target = bounce if use_split else torch.maximum(bias, bounce)
    relax = relaxation * actf
    return (list(r_a) + list(r_b) + list(nrm) + list(t1) + list(t2)
            + [inv_k_n, inv_k_t1, inv_k_t2, v_target, bias, fric, relax,
               inv_m_a, inv_m_b]
            + list(iw_a) + list(iw_b) + [lam * actf for lam in lam0])


def _rot9(q):
    w, x, y, z = q
    return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


def _gather(rows: Tensor, rank: Tensor) -> Tensor:
    """rows[:, rank] with zeros where rank < 0."""
    g = rows[:, torch.clamp(rank, min=0)]
    return torch.where((rank >= 0)[None], g, torch.zeros_like(g))


def _expq(vx, vy, vz):
    nn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    safe = torch.where(nn > 0.0, nn, torch.ones_like(nn))
    half = nn * 0.5
    sfac = torch.sin(half) / safe
    return (torch.cos(half), vx * sfac, vy * sfac, vz * sfac)


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return (w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2)


def _qnorm(a):
    w, x, y, z = a
    inv = 1.0 / torch.clamp(torch.sqrt(w * w + x * x + y * y + z * z),
                            min=1e-12)
    return (w * inv, x * inv, y * inv, z * inv)


def _sweep_once(snap, acc, cs, rank_a, rank_b, lam, *, vel_on, pos_on,
                warm_f, degf):
    """One Jacobi sweep of both solves: every contact reads the snapshot
    snap [16, NPAD] and adds its deltas into acc (snap itself or a zero
    table). cs are the constant rows (R_* layout; rows 42:45 = λ₀) of
    contacts with endpoint ranks rank_a/rank_b (−1: none), lam their
    [λn, λt1, λt2, λb]. vel_on/pos_on switch the velocity and position
    rows; warm_f (None: no warm start) blends λ₀ in; degf scatters the
    contact degrees. Returns the new lam."""
    r_a = (cs[0], cs[1], cs[2])
    r_b = (cs[3], cs[4], cs[5])
    nrm = (cs[6], cs[7], cs[8])
    t1 = (cs[9], cs[10], cs[11])
    t2 = (cs[12], cs[13], cs[14])
    inv_k_n, inv_k_t1, inv_k_t2 = cs[_R_IKN], cs[_R_IKT1], cs[_R_IKT2]
    v_target, bias = cs[_R_VTGT], cs[_R_BIAS]
    friction, relax0 = cs[_R_FRIC], cs[_R_RELAX]
    inv_m_a, inv_m_b = cs[_R_IMA], cs[_R_IMB]
    iw_a = tuple(cs[_R_IWA:_R_IWA + 9])
    iw_b = tuple(cs[_R_IWB:_R_IWB + 9])
    lam0 = cs[_R_LAM0:_R_LAM0 + 3]

    zero = torch.zeros_like(cs[0])
    ok_a, ok_b = rank_a >= 0, rank_b >= 0
    za = _gather(snap, rank_a)
    zb = _gather(snap, rank_b)
    relax = relax0 / torch.clamp(torch.maximum(za[14], zb[14]), min=1.0)

    def rel_vel(base):
        va = v3.add((za[base], za[base + 1], za[base + 2]),
                    v3.cross((za[base + 3], za[base + 4], za[base + 5]),
                             r_a))
        vb = v3.add((zb[base], zb[base + 1], zb[base + 2]),
                    v3.cross((zb[base + 3], zb[base + 4], zb[base + 5]),
                             r_b))
        return v3.sub(va, vb)

    lam_n, lam_t1, lam_t2, lam_b = lam
    v = rel_vel(0)
    v_n = v3.dot(nrm, v)
    d_lam = (v_target - v_n) * inv_k_n * relax * vel_on
    lam_n_new = torch.clamp(lam_n + d_lam, min=0.0)
    lim = friction * lam_n_new
    v_t1 = v3.dot(t1, v)
    lam_t1_new = torch.minimum(torch.maximum(
        lam_t1 - v_t1 * inv_k_t1 * relax * vel_on, -lim), lim)
    v_t2 = v3.dot(t2, v)
    lam_t2_new = torch.minimum(torch.maximum(
        lam_t2 - v_t2 * inv_k_t2 * relax * vel_on, -lim), lim)
    pv_n = v3.dot(nrm, rel_vel(8))
    d_lam_b = (bias - pv_n) * inv_k_n * relax * pos_on
    lam_b_new = torch.clamp(lam_b + d_lam_b, min=0.0)
    if warm_f is not None:
        nf = 1.0 - warm_f
        lam_n_new = warm_f * lam0[0] + nf * lam_n_new
        lam_t1_new = warm_f * lam0[1] + nf * lam_t1_new
        lam_t2_new = warm_f * lam0[2] + nf * lam_t2_new
        lam_b_new = nf * lam_b_new
    imp = v3.add(v3.add(v3.scale(nrm, lam_n_new - lam_n),
                        v3.scale(t1, lam_t1_new - lam_t1)),
                 v3.scale(t2, lam_t2_new - lam_t2))
    pimp = v3.scale(nrm, lam_b_new - lam_b)
    deg = torch.full_like(zero, degf)

    def contrib(inv_m, iw, r, sign):
        dv = v3.scale(imp, sign * inv_m)
        dw = v3.scale(v3.mat_vec(iw, v3.cross(r, imp)), sign)
        pdv = v3.scale(pimp, sign * inv_m)
        pdw = v3.scale(v3.mat_vec(iw, v3.cross(r, pimp)), sign)
        return torch.stack([*dv, *dw, zero, zero, *pdv, *pdw, deg, zero])

    ca = contrib(inv_m_a, iw_a, r_a, 1.0)
    cb = contrib(inv_m_b, iw_b, r_b, -1.0)
    acc.index_add_(1, rank_a[ok_a], ca[:, ok_a])
    acc.index_add_(1, rank_b[ok_b], cb[:, ok_b])
    return [lam_n_new, lam_t1_new, lam_t2_new, lam_b_new]


def _sweep_loop(z, cs, rank_a, rank_b, *, n_sweeps, vel_iters, pos_iters,
                warm):
    """The Jacobi sweeps of both solves on z [16, NPAD] (updated in place)
    over the constant rows cs (R_* layout; rows 42:45 = λ₀) of contacts
    with endpoint ranks rank_a/rank_b (−1: none). Sweep 0 scatters the
    contact degrees (and, with `warm`, applies λ: 0 → λ₀); sweep s ≥ 1 is
    velocity sweep s−1 while s−1 < vel_iters and position sweep while
    s−1 < pos_iters. Returns the final [λn, λt1, λt2, λb]."""
    lam = [torch.zeros_like(cs[0])] * 4
    for s in range(n_sweeps):
        i = s - 1
        lam = _sweep_once(
            z.clone(), z, cs, rank_a, rank_b, lam,
            vel_on=1.0 if 0 <= i < vel_iters else 0.0,
            pos_on=1.0 if 0 <= i < pos_iters else 0.0,
            warm_f=(1.0 if s == 0 else 0.0) if warm else None,
            degf=1.0 if s == 0 else 0.0)
    return lam


def _integrate_plain(z, pos0, quat0, dt, renorm):
    """pos/quat of every rank from the final z: pos += (v + pv)·dt,
    q ← exp(ω dt) ∘ normalize(exp(pω dt) ∘ q). pos0 [3, NPAD], quat0
    [4, NPAD] (w, x, y, z). Returns posq [8, NPAD]."""
    q0 = (quat0[0], quat0[1], quat0[2], quat0[3])
    q1 = _qnorm(_qmul(_expq(z[11] * dt, z[12] * dt, z[13] * dt), q0))
    q2 = _qmul(_expq(z[3] * dt, z[4] * dt, z[5] * dt), q1)
    if renorm:
        q2 = _qnorm(q2)
    return torch.stack([pos0[0] + (z[0] + z[8]) * dt,
                        pos0[1] + (z[1] + z[9]) * dt,
                        pos0[2] + (z[2] + z[10]) * dt,
                        *q2, torch.zeros_like(pos0[0])])


def fused_consts_plain(table, warm8, geom, *, use_split, anchored,
                       baum_over_dt, slop, relaxation):
    """The fused solve's sweep-0 constants: (the 45 constant rows, the
    endpoint ranks a and b, the refreshed depth and activity)."""
    f32 = torch.float32
    tb = table
    actf = tb[CT_ACT]
    act = actf > 0.0
    ra = tb[13].to(torch.int64)
    rb1 = tb[14].to(torch.int64)
    has_b = act & (rb1 > 0)
    rank_a = torch.where(act, ra, -1)
    rank_b = torch.where(has_b, rb1 - 1, -1)
    ga = _gather(geom[0:24], rank_a)
    gb = _gather(geom[0:24], rank_b)

    if anchored:
        r_a9 = _rot9((ga[19], ga[20], ga[21], ga[22]))
        r_b9 = _rot9((gb[19], gb[20], gb[21], gb[22]))
        aw = v3.mat_vec(r_a9, (tb[16], tb[17], tb[18]))
        a_pt = (ga[0] + aw[0], ga[1] + aw[1], ga[2] + aw[2])
        bw = v3.mat_vec(r_b9, (tb[19], tb[20], tb[21]))
        hbf = has_b.to(f32)
        b_pt = tuple(hbf * (gb[c] + bw[c]) + (1.0 - hbf) * tb[19 + c]
                     for c in range(3))
        n_w = v3.mat_vec(r_a9, (tb[22], tb[23], tb[24]))
        sep = (n_w[0] * (a_pt[0] - b_pt[0]) + n_w[1] * (a_pt[1] - b_pt[1])
               + n_w[2] * (a_pt[2] - b_pt[2]))
        d_t = tb[6] - sep
        actf_t = actf * (d_t > 0.0).to(f32)
        p_t, n_t = a_pt, n_w
    else:
        p_t = (tb[0], tb[1], tb[2])
        n_t = (tb[3], tb[4], tb[5])
        d_t = tb[6]
        actf_t = actf
    cs = _prep_consts_math(
        ga, gb, p_t, n_t, d_t, tb[7], tb[8], actf_t,
        (warm8[0], warm8[1], warm8[2]),
        (has_b & (actf_t > 0.0)).to(f32),
        baum_over_dt=baum_over_dt, slop=slop, relaxation=relaxation,
        use_split=use_split)
    return cs, rank_a, rank_b, d_t, actf_t


def banded_sweeps_fused_plain(table, warm8, geom, *, vel_iters, pos_iters,
                              use_split, anchored, integrate,
                              baum_over_dt, slop, relaxation):
    """Plain version of the fused solve kernel, all contacts at once.
    Returns (z [16, NPAD], lam4 [4, Cp], posq [8, NPAD] | None); lam4 row
    3 is the refreshed depth·activity on anchored paths, λ_b otherwise."""
    cs, rank_a, rank_b, d_t, actf_t = fused_consts_plain(
        table, warm8, geom, use_split=use_split, anchored=anchored,
        baum_over_dt=baum_over_dt, slop=slop, relaxation=relaxation)
    f32 = torch.float32
    z = torch.zeros((Z_ROWS, geom.shape[1]), dtype=f32, device=geom.device)
    z[0:6] = geom[13:19]
    lam = _sweep_loop(z, cs, rank_a, rank_b,
                      n_sweeps=max(vel_iters, pos_iters) + 1,
                      vel_iters=vel_iters, pos_iters=pos_iters,
                      warm=use_split)
    if anchored:
        lam[3] = d_t * actf_t
    pq = None
    if integrate is not None:
        pq = _integrate_plain(z, geom[0:3], geom[19:23], *integrate)
    return z, torch.stack(lam), pq


def _unpermute(rows: Tensor, order: Tensor | None, n: int) -> Tensor:
    """Rank-space rows → body order: body b's values live at column
    rank[b] (column b when order is None)."""
    if order is None:
        return rows[:, :n]
    rank_inv = torch.empty((n,), dtype=torch.int64, device=rows.device)
    rank_inv[order.long()] = torch.arange(n, device=rows.device)
    return rows[:, rank_inv]


def solve_impulses_table(state, table: Tensor, cfg, order, warm_rows,
                         geom: Tensor):
    """The fused solve over the bucket-aligned contact table with its
    integration epilogue (the port's solve_impulses_table with fuse_prep
    and fuse_integrate). Returns (vel, omega, lam3, metrics, keys,
    (pos, quat)) in body-id order; `keys` are the table-aligned feature
    keys for the next step's warm match."""
    n = state.num_bodies
    _, ccap, cp = table_shape(n, cfg)
    if table.shape[1] != cp:
        raise ValueError(f"table width {table.shape[1]} != {cp}")
    _, npad = geom_pad(n, cfg)
    if geom.shape != (48, npad):
        raise ValueError(f"geom must be [48, {npad}]")
    keys = table_keys(table)
    use_split = warm_rows is not None
    pos_iters = cfg.position_iters if use_split else 0
    warm8 = (warm_rows if use_split
             else torch.zeros((8, cp), dtype=torch.float32,
                              device=table.device))
    anchored = cfg.contact_rebuild > 1
    z, lam4, pq = banded_sweeps_fused_plain(
        table, warm8, geom, vel_iters=cfg.contact_iters,
        pos_iters=pos_iters, use_split=use_split, anchored=anchored,
        integrate=(cfg.dt, cfg.renormalize_quat),
        baum_over_dt=cfg.baumgarte / cfg.dt, slop=cfg.penetration_slop,
        relaxation=cfg.contact_relaxation)
    if anchored:
        # anchored refresh: depth·activity re-derived in sweep 0
        act, depth_act = lam4[3] > 0.0, lam4[3]
    else:
        act = table[CT_ACT] > 0.0
        depth_act = torch.where(act, table[CT_D],
                                torch.zeros_like(table[CT_D]))
    zz = _unpermute(torch.cat([z[0:6], pq[0:7]]), order, n)
    lam3 = lam4[:3].contiguous()
    metrics: Dict[str, Tensor] = {
        "contact_count": torch.sum(act.to(torch.int32)).to(torch.int32),
        "max_penetration": torch.clamp(torch.max(depth_act), min=0.0),
    }
    return (zz[0:3].T.contiguous(), zz[3:6].T.contiguous(), lam3, metrics,
            keys, (zz[6:9].T.contiguous(), zz[9:13].T.contiguous()))
