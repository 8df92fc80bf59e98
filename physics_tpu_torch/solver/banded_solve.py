"""Banded contact solve over the bucket-aligned contact table: CUDA kernel
and its plain PyTorch version (counterpart of physics_tpu/solver/
contacts_pallas.py: `_prep_consts_math`, `banded_sweeps_fused`,
`solve_impulses_table` (fused branch) and `_table_solve_outputs`).

Projected Jacobi with split impulses on a packed velocity table
z [16, NPAD] in sweep-rank order (rows 0:3 v, 3:6 ω, 8:11 pseudo v, 11:14
pseudo ω, 14 contact degree). Sweep 0 builds each contact's constants
from the table and the geometry (re-deriving point, normal and depth from
the body-frame anchors on anchored paths), scatters the endpoint degrees
and applies the warm-start impulses; sweeps 1..S each read a snapshot of
z and add every contact's impulse deltas, relaxed by 1/degree and
Coulomb-clamped; the epilogue integrates pos/quat from the final z.

The TPU kernel moved z through one-hot matmuls with hi/lo bf16 splits
(about 2⁻¹⁷ relative per read); here every read is an exact f32 gather,
and the deltas are summed with atomics (kernel) or index_add (plain) in
an order that is not the TPU's — so results agree to a tolerance.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops.contact_table import (
    CT_ACT,
    CT_D,
    geom_pad,
    table_keys,
    table_shape,
)
from physics_tpu_torch.state import SimState

Tensor = torch.Tensor

# consts rows ([R_CONST, Cp])
_R_RA, _R_RB, _R_N, _R_T1, _R_T2 = 0, 3, 6, 9, 12
_R_IKN, _R_IKT1, _R_IKT2, _R_VTGT, _R_BIAS = 15, 16, 17, 18, 19
_R_FRIC, _R_RELAX, _R_IMA, _R_IMB, _R_IWA, _R_IWB = 20, 21, 22, 23, 24, 33
_R_LAM0 = 42
R_CONST = 48
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


def banded_sweeps_fused_plain(table, warm8, geom, *, vel_iters, pos_iters,
                              use_split, anchored, integrate,
                              baum_over_dt, slop, relaxation):
    """Plain version of the solve kernel, all contacts at once. Returns
    (z [16, NPAD], lam4 [4, Cp], posq [8, NPAD] | None); lam4 row 3 is the
    refreshed depth·activity on anchored paths, λ_b otherwise."""
    dev = geom.device
    npad = geom.shape[1]
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

    z = torch.zeros((Z_ROWS, npad), dtype=f32, device=dev)
    z[0:6] = geom[13:19]
    cp = tb.shape[1]
    lam = [torch.zeros((cp,), dtype=f32, device=dev) for _ in range(4)]
    ok_a, ok_b = rank_a >= 0, rank_b >= 0
    idx_a, idx_b = rank_a[ok_a], rank_b[ok_b]
    n_sweeps = max(vel_iters, pos_iters) + 1
    zero = torch.zeros((cp,), dtype=f32, device=dev)

    for s in range(n_sweeps):
        snap = z.clone()
        za = _gather(snap, rank_a)
        zb = _gather(snap, rank_b)
        i = s - 1
        vel_on = 1.0 if 0 <= i < vel_iters else 0.0
        pos_on = 1.0 if 0 <= i < pos_iters else 0.0
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
        if use_split:
            wf = 1.0 if s == 0 else 0.0
            nf = 1.0 - wf
            lam_n_new = wf * lam0[0] + nf * lam_n_new
            lam_t1_new = wf * lam0[1] + nf * lam_t1_new
            lam_t2_new = wf * lam0[2] + nf * lam_t2_new
            lam_b_new = nf * lam_b_new
        imp = v3.add(v3.add(v3.scale(nrm, lam_n_new - lam_n),
                            v3.scale(t1, lam_t1_new - lam_t1)),
                     v3.scale(t2, lam_t2_new - lam_t2))
        pimp = v3.scale(nrm, lam_b_new - lam_b)
        deg = torch.full_like(zero, 1.0 if s == 0 else 0.0)

        def contrib(inv_m, iw, r, sign):
            dv = v3.scale(imp, sign * inv_m)
            dw = v3.scale(v3.mat_vec(iw, v3.cross(r, imp)), sign)
            pdv = v3.scale(pimp, sign * inv_m)
            pdw = v3.scale(v3.mat_vec(iw, v3.cross(r, pimp)), sign)
            return torch.stack([*dv, *dw, zero, zero, *pdv, *pdw, deg, zero])

        ca = contrib(inv_m_a, iw_a, r_a, 1.0)
        cb = contrib(inv_m_b, iw_b, r_b, -1.0)
        z.index_add_(1, idx_a, ca[:, ok_a])
        z.index_add_(1, idx_b, cb[:, ok_b])
        lam = [lam_n_new, lam_t1_new, lam_t2_new, lam_b_new]

    if anchored:
        lam[3] = d_t * actf_t
    lam4 = torch.stack(lam)

    pq = None
    if integrate is not None:
        dt, renorm = integrate
        q0 = (geom[19], geom[20], geom[21], geom[22])
        q1 = _qnorm(_qmul(_expq(z[11] * dt, z[12] * dt, z[13] * dt), q0))
        q2 = _qmul(_expq(z[3] * dt, z[4] * dt, z[5] * dt), q1)
        if renorm:
            q2 = _qnorm(q2)
        pq = torch.stack([geom[0] + (z[0] + z[8]) * dt,
                          geom[1] + (z[1] + z[9]) * dt,
                          geom[2] + (z[2] + z[10]) * dt,
                          *q2, torch.zeros_like(geom[0])])
    return z, lam4, pq


def banded_sweeps_fused(table: Tensor, warm8: Tensor, geom: Tensor,
                        cfg: SimConfig, *, vel_iters: int, pos_iters: int,
                        use_split: bool,
                        integrate: Tuple[float, bool] | None = None,
                        plain: bool = False):
    """The fused solve from contact table to solved (and integrated) state.

    table [16|32, Cp] (ops/contact_table.py rows), warm8 [8, Cp] (rows
    0:3 = λ₀), geom [48, NPAD] unified geometry. Returns (z [16, NPAD],
    lam4 [4, Cp], posq [8, NPAD] | None). The schedule is
    max(vel_iters, pos_iters) + 1 sweeps.

    A CPU tensor (or `plain=True`) runs the plain version; a CUDA tensor
    launches csrc/banded_solve.cu."""
    anchored = cfg.contact_rebuild > 1
    kw = dict(vel_iters=vel_iters, pos_iters=pos_iters, use_split=use_split,
              anchored=anchored, integrate=integrate,
              baum_over_dt=cfg.baumgarte / cfg.dt,
              slop=cfg.penetration_slop, relaxation=cfg.contact_relaxation)
    if plain or geom.device.type == "cpu":
        return banded_sweeps_fused_plain(table, warm8, geom, **kw)
    if geom.device.type != "cuda":
        raise ValueError(f"banded solve: unsupported device {geom.device}")
    return _launch_kernel(table, warm8, geom, **kw)


banded_sweeps_fused.launches = 0


def _launch_kernel(table, warm8, geom, *, vel_iters, pos_iters, use_split,
                   anchored, integrate, baum_over_dt, slop, relaxation):
    from physics_tpu_torch import _build

    dev = geom.device
    trows, cp = table.shape
    npad = geom.shape[1]
    need_rows = 25 if anchored else 16
    for name, t, shape in (("table", table, (trows, cp)),
                           ("warm8", warm8, (8, cp)),
                           ("geom", geom, (48, npad))):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"banded solve: {name} must be a contiguous "
                             f"f32 {list(shape)} tensor on {dev}")
    if trows < need_rows:
        raise ValueError(f"banded solve: table [{trows}, {cp}] too small")
    n_sweeps = max(vel_iters, pos_iters) + 1
    f32 = torch.float32
    z = torch.empty((Z_ROWS, npad), dtype=f32, device=dev)
    lam4 = torch.empty((4, cp), dtype=f32, device=dev)
    pq = (torch.empty((8, npad), dtype=f32, device=dev)
          if integrate is not None else None)
    consts = torch.empty((R_CONST, cp), dtype=f32, device=dev)
    zread = torch.empty((Z_ROWS, npad), dtype=f32, device=dev)
    flags = ((_build.FLAG_USE_SPLIT if use_split else 0)
             | (_build.FLAG_ANCHORED if anchored else 0))
    dt = 0.0
    if integrate is not None:
        dt = integrate[0]
        flags |= _build.FLAG_INTEGRATE
        flags |= _build.FLAG_RENORM if integrate[1] else 0
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = _build.library().bs_banded_solve(
            ptr(table.data_ptr()), ptr(warm8.data_ptr()),
            ptr(geom.data_ptr()), ptr(z.data_ptr()), ptr(lam4.data_ptr()),
            ptr(pq.data_ptr() if pq is not None else 0),
            ptr(consts.data_ptr()), ptr(zread.data_ptr()),
            cp, npad, trows, n_sweeps, vel_iters, pos_iters,
            ctypes.c_float(baum_over_dt), ctypes.c_float(slop),
            ctypes.c_float(relaxation), ctypes.c_float(dt), flags,
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "bs_banded_solve")
    banded_sweeps_fused.launches += 1
    return z, lam4, pq


def solve_impulses_table(state: SimState, table: Tensor, cfg: SimConfig,
                         order: Tensor, warm_rows: Tensor | None,
                         geom: Tensor, plain: bool = False):
    """Banded solve over the contact table (the branch of the JAX
    package's solve_impulses_table with fused prep and fused
    integration). Returns (vel, omega, lam3, metrics, keys, (pos, quat))
    — body fields in body-id order, `keys` the table-aligned feature keys
    for the next step's warm match."""
    n = state.num_bodies
    nb, ccap, cp = table_shape(n, cfg)
    if table.shape[1] != cp:
        raise ValueError(f"table width {table.shape[1]} != {cp}")
    _, npad = geom_pad(n, cfg)
    if not (cfg.fuse_prep and cfg.fuse_integrate):
        raise NotImplementedError(
            "only the fused prep + fused integration solve is ported; the "
            "unfused table solve is ROADMAP kernels 2.5/2.6")
    if geom.shape != (48, npad):
        raise ValueError(f"geom must be [48, {npad}]")
    keys = table_keys(table)
    use_split = warm_rows is not None
    warm8 = (warm_rows if use_split
             else torch.zeros((8, cp), dtype=torch.float32,
                              device=table.device))
    z, lam4, pq = banded_sweeps_fused(
        table, warm8, geom, cfg,
        vel_iters=cfg.contact_iters,
        pos_iters=cfg.position_iters if use_split else 0,
        use_split=use_split, integrate=(cfg.dt, cfg.renormalize_quat),
        plain=plain)
    if cfg.contact_rebuild > 1:
        depth_act = lam4[3]
        act_t = depth_act > 0.0
    else:
        act = table[CT_ACT] > 0.0
        depth_act = torch.where(act, table[CT_D], torch.zeros_like(
            table[CT_D]))
        act_t = act
    return _table_solve_outputs(z, lam4, pq, depth_act, act_t, keys, order,
                                n)


def _table_solve_outputs(z, lam4, pq, depth_act, act, keys, order, n):
    """Un-permute the solved rank-space rows to body order, plus the
    solve's metrics."""
    big = torch.cat([z[0:6], pq[0:7]])
    rank_inv = torch.empty((n,), dtype=torch.int64, device=z.device)
    rank_inv[order.long()] = torch.arange(n, device=z.device)
    zz = big[:, rank_inv]
    lam3 = lam4[:3].contiguous()
    metrics: Dict[str, Tensor] = {
        "contact_count": torch.sum(act.to(torch.int32)).to(torch.int32),
        "max_penetration": torch.clamp(torch.max(depth_act), min=0.0),
        "normal_impulse_sum": torch.sum(lam3[0]),
        "band_overflow": torch.zeros((), dtype=torch.int32,
                                     device=z.device),
    }
    vel = zz[0:3].T.contiguous()
    omega = zz[3:6].T.contiguous()
    pos = zz[6:9].T.contiguous()
    quat = zz[9:13].T.contiguous()
    return vel, omega, lam3, metrics, keys, (pos, quat)
