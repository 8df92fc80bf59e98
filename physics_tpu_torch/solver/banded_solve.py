"""Banded contact solves: four CUDA kernels and their plain PyTorch
versions (counterpart of physics_tpu/solver/contacts_pallas.py:
`_prep_consts_math`, `banded_sweeps_fused`, `prep_consts`,
`banded_sweeps`, `banded_sweep_once`, `banded_sweeps_sharded`,
`solve_shape`, `padded_contact_count`, `solve_impulses_banded`,
`solve_impulses_table` and `_table_solve_outputs`).

Projected Jacobi with split impulses on a packed velocity table
z [16, NPAD] in sweep-rank order (rows 0:3 v, 3:6 ω, 8:11 pseudo v, 11:14
pseudo ω, 14 contact degree). Sweep 0 scatters the endpoint degrees and
applies the warm-start impulses; sweeps 1..S each read a snapshot of z
and add every contact's impulse deltas, relaxed by 1/degree and
Coulomb-clamped; the epilogue integrates pos/quat from the final z. On
the card the fused and the unfused solve are each one persistent launch
whose later sweeps visit only the contacts with a relaxation or an
impulse (the others add exact zeros).
The fused solve (kernel 2.3) builds each contact's constants in its
sweep 0 from the contact table and the geometry (re-deriving point,
normal and depth from the body-frame anchors on anchored paths); the
unfused one (banded_sweeps, 2.5, for the generic banded path and the
table path with fuse_prep off) builds them in its sweep 0 from the
contact rows `cin` and the geometry: the TPU's prep_consts (2.6) is
folded into that sweep 0, and prep_consts_plain is its plain version.
The row-sharded solve splits the unfused sweeps' tiles over the ranks:
each sweep is one launch of banded_sweep_once (2.7) per rank, which
writes the sweep's delta of z, and an all-reduce of that delta, which
the next launch folds into its snapshot (banded_sweeps_sharded); its
sweep 0 builds the constants of the rank's own slots (2.6 folded in
again) and its later sweeps visit only the rank's live contacts too.

The TPU kernel moved z through one-hot matmuls with hi/lo bf16 splits
(about 2⁻¹⁷ relative per read); here every read is an exact f32 gather,
and the deltas are summed with atomics (kernel) or index_add (plain) in
an order that is not the TPU's — so results agree to a tolerance.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Dict, Iterator, NamedTuple, Tuple

import torch

from physics_tpu_torch import tracing
from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops.contact_table import (
    BLOCK,
    CT_ACT,
    CT_D,
    CT_MU,
    CT_N,
    CT_PT,
    CT_RA,
    CT_RB1,
    CT_REST,
    _round_up,
    geom_pad,
    table_keys,
    table_shape,
)
from physics_tpu_torch.ops.narrowphase_banded import body_table_width
from physics_tpu_torch.parallel.collectives import (
    Shard,
    all_gather_last,
    all_reduce_sum,
)
from physics_tpu_torch.state import SimState

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

# Whether a step computes its metrics (the solves' contact_count,
# max_penetration, normal_impulse_sum and band_overflow; the CG's
# iterations and convergence in engine.solve_joints): yes unless within
# metrics_off, which engine.step (and so every captured graph) runs under
_METRICS: contextvars.ContextVar = contextvars.ContextVar(
    "step_metrics", default=True)


@contextlib.contextmanager
def metrics_off() -> Iterator[None]:
    """Within the block the step computes no metrics: the metric dicts
    come back without them."""
    token = _METRICS.set(False)
    try:
        yield
    finally:
        _METRICS.reset(token)


def metrics_wanted() -> bool:
    return _METRICS.get()


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
    launches csrc/banded_solve.cu.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
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


def _solve_scratch(cp: int, npad: int, dev):
    """Scratch of the persistent solve (csrc/banded_solve.cu
    solve_kernel): the constants [48, Cp] (R_* rows; the endpoint ranks
    too in 2.3), the two body-major z tables [2, NPAD, 16], the λ,
    previous impulse and relaxation [9, Cp] of the live contacts a block
    cannot hold in shared memory, and the blocks' live lists (each block's
    share of the slots rounded up to 32: room for 1,024 blocks)."""
    f32 = torch.float32
    return (torch.empty((R_CONST, cp), dtype=f32, device=dev),
            torch.empty((2, npad, Z_ROWS), dtype=f32, device=dev),
            torch.empty((9, cp), dtype=f32, device=dev),
            torch.empty((cp + 32 * 1024,), dtype=torch.int32, device=dev))


def solve_plan(fused: bool, cp: int, dev) -> Dict[str, int]:
    """The persistent solve's launch for a table of cp slots on CUDA
    device `dev` (fused: 2.3, else 2.5) and its kernel's resources."""
    from physics_tpu_torch import _build

    out = (ctypes.c_int * 7)()
    with torch.cuda.device(dev):
        err = _build.library().bs_solve_plan(
            int(fused), cp, ctypes.cast(out, ctypes.c_void_p))
    _build.check(err, "bs_solve_plan")
    return dict(zip(("grid", "slots_a_block", "held_a_block", "smem_bytes",
                     "blocks_an_sm", "registers", "local_bytes"), out))


def _launch_kernel(table, warm8, geom, *, vel_iters, pos_iters, use_split,
                   anchored, integrate, baum_over_dt, slop, relaxation):
    from physics_tpu_torch import _build

    dev = geom.device
    trows, cp = table.shape
    npad = geom.shape[1]
    need_rows = 25 if anchored else 16
    _build.check_operands("banded solve", dev,
                          ("table", table, torch.float32, (trows, cp)),
                          ("warm8", warm8, torch.float32, (8, cp)),
                          ("geom", geom, torch.float32, (48, npad)))
    if trows < need_rows:
        raise ValueError(f"banded solve: table [{trows}, {cp}] too small")
    n_sweeps = max(vel_iters, pos_iters) + 1
    f32 = torch.float32
    z = torch.empty((Z_ROWS, npad), dtype=f32, device=dev)
    lam4 = torch.empty((4, cp), dtype=f32, device=dev)
    pq = (torch.empty((8, npad), dtype=f32, device=dev)
          if integrate is not None else None)
    consts, zt, st, lst = _solve_scratch(cp, npad, dev)
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
            ptr(consts.data_ptr()), ptr(zt.data_ptr()), ptr(st.data_ptr()),
            ptr(lst.data_ptr()), lst.numel(), cp, npad, trows, n_sweeps,
            vel_iters, pos_iters, ctypes.c_float(baum_over_dt),
            ctypes.c_float(slop),
            ctypes.c_float(relaxation), ctypes.c_float(dt), flags,
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "bs_banded_solve")
    banded_sweeps_fused.launches += 1
    return z, lam4, pq


# ---------------------------------------------------------------------------
# the unfused solve: banded_sweeps (2.5, with 2.6 in its sweep 0)
# ---------------------------------------------------------------------------

def _win_rank(bases: Tensor, loc: Tensor, tile: int) -> Tensor:
    """Rank of each contact's window-local index loc [Cp] (−1: none):
    the base of its tile of `tile` contacts plus loc."""
    base = bases.to(torch.int64).repeat_interleave(tile)
    return torch.where(loc >= 0, base + loc.to(torch.int64), -1)


def _cin(point, normal, depth, friction, restitution, actf, lam0, has_bf):
    """The contact rows the constants read, cin [CIN_ROWS, Cp]: point
    0:3, normal 3:6, depth, friction, restitution, activity, λ₀ 10:13,
    has_b."""
    return torch.stack([*point, *normal, depth, friction, restitution, actf,
                        *lam0, has_bf])


def prep_kw(cfg: SimConfig, use_split: bool) -> Dict:
    """The keywords of the constants (2.6) that the config and the
    warm-start switch give: what banded_sweeps, banded_sweep_once and
    banded_sweeps_sharded take beside `cin`."""
    return dict(use_split=use_split, baum_over_dt=cfg.baumgarte / cfg.dt,
                slop=cfg.penetration_slop, relaxation=cfg.contact_relaxation)


def prep_consts_plain(geom, bases, la, lb, cin, *, tile, baum_over_dt, slop,
                      relaxation, use_split):
    """Plain version of kernel 2.6 (folded into sweep 0 of 2.5 and 2.7 on
    the card): geom [48, NPAD] rank-space geometry table (solve rows 0:24
    read), bases [Cp / tile] int32 window starts, la/lb [Cp] int32
    window-local endpoint ranks (−1: none), cin [CIN_ROWS, Cp] contact
    rows (see _cin) → consts [R_PREP, Cp]. The TPU kernel's rows 45:48
    (zero there, and read by no sweep) are not written."""
    ga = _gather(geom[0:24], _win_rank(bases, la, tile))
    gb = _gather(geom[0:24], _win_rank(bases, lb, tile))
    cs = _prep_consts_math(
        ga, gb, (cin[0], cin[1], cin[2]), (cin[3], cin[4], cin[5]), cin[6],
        cin[7], cin[8], cin[9], (cin[10], cin[11], cin[12]), cin[13],
        baum_over_dt=baum_over_dt, slop=slop, relaxation=relaxation,
        use_split=use_split)
    return torch.stack(cs)


def touched(consts: Tensor, ra: Tensor, rb: Tensor) -> Tensor:
    """The slots whose constants sweep 0 builds [Cp] bool: an endpoint
    (ranks ra/rb, −1: none) or a relaxation; the others change nothing."""
    return (ra >= 0) | (rb >= 0) | (consts[_R_RELAX] != 0)


def _prep_plain(geom, bases, la, lb, cin, consts_out, tile, kw):
    """2.6's plain constants, into consts_out at the touched slots too
    (as the kernels write it)."""
    consts = prep_consts_plain(geom, bases, la, lb, cin, tile=tile, **kw)
    if consts_out is not None:
        t = touched(consts, _win_rank(bases, la, tile),
                    _win_rank(bases, lb, tile))
        consts_out[:, t] = consts[:, t]
    return consts


def banded_sweeps_plain(z0, bases, la, lb, geom, cin, *, tile, vel_iters,
                        pos_iters, use_split, baum_over_dt, slop, relaxation,
                        posq, integrate, consts_out=None):
    """Plain version of the sweep kernel: prep_consts_plain, then the
    sweep loop. Returns (z [16, NPAD], lam4 [4, Cp], posq [8, NPAD] |
    None)."""
    consts = _prep_plain(geom, bases, la, lb, cin, consts_out, tile, dict(
        use_split=use_split, baum_over_dt=baum_over_dt, slop=slop,
        relaxation=relaxation))
    z = z0.clone()
    lam = _sweep_loop(z, consts, _win_rank(bases, la, tile),
                      _win_rank(bases, lb, tile),
                      n_sweeps=max(vel_iters, pos_iters) + 1,
                      vel_iters=vel_iters, pos_iters=pos_iters,
                      warm=use_split)
    pq = None
    if integrate is not None:
        pq = _integrate_plain(z, posq[0:3], posq[3:7], *integrate)
    return z, torch.stack(lam), pq


def _check_cin(what: str, dev, cin: Tensor, cp: int) -> None:
    """cin [CIN_ROWS, cp] f32 on dev, rows contiguous: a whole tensor or
    a slice of columns of one."""
    if (cin.device != dev or cin.dtype != torch.float32
            or tuple(cin.shape) != (CIN_ROWS, cp) or cin.stride(1) != 1
            or cin.stride(0) < cp):
        raise ValueError(f"{what}: cin must be a float32 [{CIN_ROWS}, {cp}] "
                         f"tensor (or columns of one) on {dev}")


def banded_sweeps(z0: Tensor, bases: Tensor, la: Tensor, lb: Tensor,
                  geom: Tensor, cin: Tensor, *, tile: int, vel_iters: int,
                  pos_iters: int, use_split: bool, baum_over_dt: float,
                  slop: float, relaxation: float,
                  posq: Tensor | None = None,
                  integrate: Tuple[float, bool] | None = None,
                  consts_out: Tensor | None = None, plain: bool = False):
    """The unfused solve: each contact's constants (2.6) from its contact
    rows cin [CIN_ROWS, Cp] (see _cin) and the geometry table geom [48,
    NPAD] (solve rows 0:24), then the Jacobi sweep loop (2.5). z0 [16,
    NPAD] packed rank-space velocities, bases [Cp / tile] int32 window
    starts, la/lb [Cp] int32 window-local endpoint ranks (−1: none).
    max(vel_iters, pos_iters) + 1 sweeps; sweep 0 builds the constants,
    scatters the degrees and, with use_split, applies the warm start (the
    split impulses: see prep_kw). posq [8, NPAD] (pos xyz, quat wxyz)
    with integrate=(dt, renormalize) adds the integration epilogue.
    consts_out [R_PREP, Cp], when given, receives every touched slot's
    constants (2.6's output, to check the fold; the step passes none).
    Returns (z, lam4 [4, Cp], posq out | None).

    A CPU tensor (or `plain=True`) runs the plain version; a CUDA tensor
    launches csrc/banded_solve.cu bs_banded_sweeps, one launch with 2.6
    in its sweep 0.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    if (posq is None) != (integrate is None):
        raise ValueError("banded sweeps: posq and integrate go together")
    kw = dict(tile=tile, vel_iters=vel_iters, pos_iters=pos_iters,
              use_split=use_split, baum_over_dt=baum_over_dt, slop=slop,
              relaxation=relaxation, posq=posq, integrate=integrate,
              consts_out=consts_out)
    if plain or z0.device.type == "cpu":
        return banded_sweeps_plain(z0, bases, la, lb, geom, cin, **kw)
    if z0.device.type != "cuda":
        raise ValueError(f"banded sweeps: unsupported device {z0.device}")
    from physics_tpu_torch import _build

    dev = z0.device
    cp = la.shape[0]
    npad = z0.shape[1]
    if cp % tile:
        raise ValueError(f"banded sweeps: {cp} contacts, tile {tile}")
    _build.check_operands("banded sweeps", dev,
                    ("z0", z0, torch.float32, (Z_ROWS, npad)),
                    ("bases", bases, torch.int32, (cp // tile,)),
                    ("la", la, torch.int32, (cp,)),
                    ("lb", lb, torch.int32, (cp,)),
                    ("geom", geom, torch.float32, (48, npad)),
                    ("cin", cin, torch.float32, (CIN_ROWS, cp)),
                    *([("posq", posq, torch.float32, (8, npad))]
                      if posq is not None else []),
                    *([("consts_out", consts_out, torch.float32,
                        (R_PREP, cp))] if consts_out is not None else []))
    f32 = torch.float32
    z = torch.empty((Z_ROWS, npad), dtype=f32, device=dev)
    lam4 = torch.empty((4, cp), dtype=f32, device=dev)
    pq = (torch.empty((8, npad), dtype=f32, device=dev)
          if integrate is not None else None)
    consts, zt, st, lst = _solve_scratch(cp, npad, dev)
    flags = _build.FLAG_USE_SPLIT if use_split else 0
    dt = 0.0
    if integrate is not None:
        dt = integrate[0]
        flags |= _build.FLAG_INTEGRATE
        flags |= _build.FLAG_RENORM if integrate[1] else 0
    ptr = ctypes.c_void_p

    def addr(t):
        return ptr(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(dev):
        err = _build.library().bs_banded_sweeps(
            *[addr(t) for t in (z0, bases, la, lb, geom, cin, consts,
                                consts_out, posq, z, lam4, pq, zt, st, lst)],
            lst.numel(), cp, npad, tile, max(vel_iters, pos_iters) + 1,
            vel_iters, pos_iters, ctypes.c_float(baum_over_dt),
            ctypes.c_float(slop), ctypes.c_float(relaxation),
            ctypes.c_float(dt), flags,
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "bs_banded_sweeps")
    banded_sweeps.launches += 1
    return z, lam4, pq


banded_sweeps.launches = 0


# ---------------------------------------------------------------------------
# the sharded sweeps: banded_sweep_once (2.7) and its loop
# ---------------------------------------------------------------------------

# z row r of a body lives at column ZSLOT[r] of its row of a body-major
# table (csrc/banded_solve.cu zslot: v, ω, pseudo v, pseudo ω, degree, then
# rows 6, 7 and 15); ZROW inverts it
ZSLOT = (0, 1, 2, 3, 4, 5, 13, 14, 6, 7, 8, 9, 10, 11, 12, 15)
ZROW = tuple(ZSLOT.index(c) for c in range(Z_ROWS))


def rows_of(zb: Tensor) -> Tensor:
    """A body-major table [NPAD, 16] as z rows [16, NPAD]."""
    return zb[:, list(ZSLOT)].T


class SweepScratch(NamedTuple):
    """One rank's state across the sweeps of its sharded solve (2.7):
    the snapshot tables, the delta tables (the ranks all-reduce dz[s % 3]
    after sweep s), λ by slot, the live list and its length, the endpoint
    ranks and the relaxation over the degrees by list entry, and the
    sweep constants by slot (sweep 0 builds them: 2.6 folded in)."""

    zt: Tensor      # [2, NPAD, 16] f32, body-major (ZSLOT)
    dz: Tensor      # [3, NPAD, 16] f32
    lam: Tensor     # [4, C] f32
    live: Tensor    # [C] int32
    count: Tensor   # [1] int32
    ends: Tensor    # [2, C] int32 endpoint ranks (−1: none)
    relax: Tensor   # [C] f32
    consts: Tensor  # [R_SWEEP, C] f32 (R_* rows 0:42)


def sweep_scratch(c: int, npad: int, device) -> SweepScratch:
    """A rank's scratch for C contacts: the delta tables and the live
    count zeroed (one device operation), the rest uninitialised."""
    f32 = torch.float32
    zeroed = torch.zeros((3 * npad * Z_ROWS + 4,), dtype=f32, device=device)
    return SweepScratch(
        torch.empty((2, npad, Z_ROWS), dtype=f32, device=device),
        zeroed[:-4].view(3, npad, Z_ROWS), torch.empty((4, c), dtype=f32,
                                                        device=device),
        torch.empty((c,), dtype=torch.int32, device=device),
        zeroed[-4:].view(torch.int32)[:1],
        torch.empty((2, c), dtype=torch.int32, device=device),
        torch.empty((c,), dtype=f32, device=device),
        torch.empty((R_SWEEP, c), dtype=f32, device=device))


def sweep_result(sc: SweepScratch, sweep: int) -> Tensor:
    """z [16, NPAD] after sweep `sweep` and the all-reduce of its delta:
    the same f32 add the next sweep would make."""
    return rows_of(sc.zt[sweep % 2] + sc.dz[sweep % 3])


def banded_sweep_once_plain(sc, z0, bases, la, lb, geom, cin, *, sweep,
                            tile, vel_on, pos_on, use_split, baum_over_dt,
                            slop, relaxation, consts_out=None):
    """Plain version of the sharded sweep kernel, on the same scratch."""
    ra_all, rb_all = _win_rank(bases, la, tile), _win_rank(bases, lb, tile)
    zw = sc.dz[sweep % 3]
    if sweep == 0:
        consts = _prep_plain(geom, bases, la, lb, cin, consts_out, tile, dict(
            use_split=use_split, baum_over_dt=baum_over_dt, slop=slop,
            relaxation=relaxation))
        sc.consts.copy_(consts[:R_SWEEP])
        sc.zt[0] = z0[list(ZROW)].T
        acc = torch.zeros_like(z0)
        lam = _sweep_once(
            torch.zeros_like(z0), acc, consts, ra_all, rb_all,
            [torch.zeros_like(consts[0])] * 4, vel_on=0.0, pos_on=0.0,
            warm_f=1.0 if use_split else None, degf=1.0)
        zw += acc[list(ZROW)].T
        sc.lam.copy_(torch.stack(lam))
        live = touched(consts, ra_all, rb_all) & (
            (consts[_R_RELAX] != 0) | (sc.lam[0:3] != 0).any(0))
        idx = torch.nonzero(live).flatten()
        sc.live[:idx.numel()] = idx.to(torch.int32)
        sc.count.fill_(idx.numel())
        sc.ends[:, :idx.numel()] = torch.stack([ra_all[idx], rb_all[idx]])
        return
    snap = sc.zt[(sweep - 1) % 2] + sc.dz[(sweep - 1) % 3]
    sc.zt[sweep % 2] = snap
    sc.dz[(sweep + 1) % 3] = 0.0
    m = int(sc.count[0])
    j = sc.live[:m].long()
    ra, rb = sc.ends[0, :m].long(), sc.ends[1, :m].long()
    z = rows_of(snap)
    acc = torch.zeros_like(z)
    lam = _sweep_once(z, acc, sc.consts[:, j], ra, rb, list(sc.lam[:, j]),
                      vel_on=1.0 if vel_on else 0.0,
                      pos_on=1.0 if pos_on else 0.0, warm_f=None, degf=0.0)
    sc.lam[:, j] = torch.stack(lam)
    if sweep == 1:
        deg = torch.maximum(_gather(z[14:15], ra)[0], _gather(z[14:15], rb)[0])
        sc.relax[:m] = sc.consts[_R_RELAX, j] / torch.clamp(deg, min=1.0)
    zw += acc[list(ZROW)].T


def banded_sweep_once(sc: SweepScratch, z0: Tensor, bases: Tensor,
                      la: Tensor, lb: Tensor, geom: Tensor, cin: Tensor, *,
                      sweep: int, tile: int, vel_on: bool, pos_on: bool,
                      use_split: bool, baum_over_dt: float, slop: float,
                      relaxation: float, consts_out: Tensor | None = None,
                      plain: bool = False) -> None:
    """Sweep `sweep` of one rank's share of the sharded solve, on its
    scratch `sc` (sweep_scratch): z0 [16, NPAD] the velocity table at the
    start (read by sweep 0), bases [C / tile] int32 window starts and
    la/lb [C] int32 window-local endpoint ranks of the rank's contacts,
    geom [48, NPAD] the geometry table and cin [CIN_ROWS, C] their
    contact rows (read by sweep 0; the rank's columns of the whole cin,
    read in place). Sweep 0 builds the touched contacts' constants (2.6
    folded in; into consts_out [R_PREP, C] too when given), scatters the
    degrees and, with use_split, applies λ: 0 → λ₀, and lists the live
    contacts; a later sweep reads the snapshot (the previous snapshot
    plus the previous summed delta, which it also writes as the next
    snapshot table) and updates the listed contacts from their constants
    in sc.consts, vel_on/pos_on switching the velocity and position rows.
    The sweep's delta is added into sc.dz[sweep % 3], which the ranks
    then all-reduce; sweep_result gives z.

    A CPU tensor (or `plain=True`) runs the plain version; a CUDA tensor
    launches csrc/banded_solve.cu bs_sharded_sweep.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    kw = dict(sweep=sweep, tile=tile, vel_on=vel_on, pos_on=pos_on,
              use_split=use_split, baum_over_dt=baum_over_dt, slop=slop,
              relaxation=relaxation, consts_out=consts_out)
    if plain or z0.device.type == "cpu":
        return banded_sweep_once_plain(sc, z0, bases, la, lb, geom, cin,
                                       **kw)
    if z0.device.type != "cuda":
        raise ValueError(f"banded sweep once: unsupported device {z0.device}")
    from physics_tpu_torch import _build

    dev = z0.device
    cp = la.shape[0]
    npad = z0.shape[1]
    if cp < 1 or cp % tile or sweep < 0:
        raise ValueError(f"banded sweep once: {cp} contacts, tile {tile}, "
                         f"sweep {sweep}")
    f32, i32 = torch.float32, torch.int32
    _build.check_operands("banded sweep once", dev,
                          ("z0", z0, f32, (Z_ROWS, npad)),
                          ("bases", bases, i32, (cp // tile,)),
                          ("la", la, i32, (cp,)), ("lb", lb, i32, (cp,)),
                          ("geom", geom, f32, (48, npad)),
                          ("zt", sc.zt, f32, (2, npad, Z_ROWS)),
                          ("dz", sc.dz, f32, (3, npad, Z_ROWS)),
                          ("lam", sc.lam, f32, (4, cp)),
                          ("live", sc.live, i32, (cp,)),
                          ("count", sc.count, i32, (1,)),
                          ("ends", sc.ends, i32, (2, cp)),
                          ("relax", sc.relax, f32, (cp,)),
                          ("consts", sc.consts, f32, (R_SWEEP, cp)),
                          *([("consts_out", consts_out, f32, (R_PREP, cp))]
                            if consts_out is not None else []))
    _check_cin("banded sweep once", dev, cin, cp)
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = _build.library().bs_sharded_sweep(
            *[ptr(t.data_ptr()) for t in (z0, bases, la, lb, geom, cin)],
            cin.stride(0),
            *[ptr(t.data_ptr() if t is not None else 0)
              for t in (sc.consts, consts_out, sc.lam, sc.zt, sc.dz,
                        sc.live, sc.count, sc.ends, sc.relax)],
            cp, npad, tile, sweep, ctypes.c_float(1.0 if vel_on else 0.0),
            ctypes.c_float(1.0 if pos_on else 0.0),
            ctypes.c_float(baum_over_dt), ctypes.c_float(slop),
            ctypes.c_float(relaxation), int(use_split),
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "bs_sharded_sweep")
    banded_sweep_once.launches += 1


banded_sweep_once.launches = 0


def banded_sweeps_sharded(z0: Tensor, bases: Tensor, la: Tensor,
                          lb: Tensor, geom: Tensor, cin: Tensor, *,
                          tile: int, vel_iters: int, pos_iters: int,
                          use_split: bool, baum_over_dt: float, slop: float,
                          relaxation: float, shard: Shard,
                          plain: bool = False) -> Tuple[Tensor, Tensor]:
    """banded_sweeps with the contact tiles split over the ranks of
    `shard` (parallel.collectives.Shard): rank r builds the constants of
    tiles [r·T, (r+1)·T), T = ntiles / ranks, and sweeps them against
    the replicated z; after each sweep the ranks all-reduce its delta,
    which the next sweep adds to z. The same schedule as banded_sweeps:
    sweep 0 (constants, degrees, warm start), then max(vel_iters,
    pos_iters) sweeps, a launch each (banded_sweep_once). Takes the whole
    (replicated) operands, each rank its own columns of them in place;
    returns (z [16, NPAD], λ [4, Cp]) with λ all-gathered in rank order.
    Needs ntiles % ranks == 0."""
    cp = la.shape[0]
    ntiles = cp // tile
    if ntiles * tile != cp or ntiles % shard.size:
        raise ValueError(
            f"sharded banded solve needs whole tiles divisible by the rank "
            f"count: {cp} contacts, tile {tile}, {shard.size} ranks; round "
            f"the contact capacity up to tile·ranks")
    t_loc = ntiles // shard.size
    c_loc = t_loc * tile
    t0, c0 = shard.rank * t_loc, shard.rank * c_loc
    ops = (bases[t0:t0 + t_loc], la[c0:c0 + c_loc], lb[c0:c0 + c_loc], geom,
           cin[:, c0:c0 + c_loc])
    sc = sweep_scratch(c_loc, z0.shape[1], z0.device)
    n_sweeps = max(vel_iters, pos_iters) + 1
    for s in range(n_sweeps):
        banded_sweep_once(sc, z0, *ops, sweep=s, tile=tile,
                          vel_on=0 <= s - 1 < vel_iters,
                          pos_on=0 <= s - 1 < pos_iters, use_split=use_split,
                          baum_over_dt=baum_over_dt, slop=slop,
                          relaxation=relaxation, plain=plain)
        all_reduce_sum(sc.dz[s % 3], shard)
    return sweep_result(sc, n_sweeps - 1), all_gather_last(sc.lam, shard)


def banded_z0(geom: Tensor) -> Tensor:
    """The packed velocity table z0 [16, NPAD]: rows 0:6 the (v, ω) of
    the geometry table's solve block, the rest zero."""
    z0 = torch.zeros((Z_ROWS, geom.shape[1]), dtype=torch.float32,
                     device=geom.device)
    z0[0:6] = geom[13:19]
    return z0


def _unpermute(rows: Tensor, order: Tensor | None, n: int) -> Tensor:
    """Rank-space rows → body order: body b's values live at column
    rank[b] (column b when order is None)."""
    if order is None:
        return rows[:, :n]
    rank_inv = torch.empty((n,), dtype=torch.int64, device=rows.device)
    rank_inv[order.long()] = torch.arange(n, device=rows.device)
    return rows[:, rank_inv]


# ---------------------------------------------------------------------------
# the generic banded solve (contacts_pallas.solve_impulses_banded)
# ---------------------------------------------------------------------------

def solve_shape(n: int, c: int, cfg: SimConfig) -> Tuple[int, int, int]:
    """(tile, wtot, npad) for a solve of c contacts over n bodies; npad is
    the pair manifolds' body-table width, as one geometry table serves
    both."""
    tile = min(cfg.pallas_tile, max(_round_up(c, 128), 128))
    return tile, cfg.pallas_window, body_table_width(n, cfg)


def padded_contact_count(n: int, c: int, cfg: SimConfig) -> int:
    tile, _, _ = solve_shape(n, c, cfg)
    return _round_up(max(c, 1), tile)


def _pad_contacts(contacts, cp: int):
    """Zero-pad every field to cp slots (zero ⇒ inactive, key 0)."""
    pad = cp - contacts.body_a.shape[0]
    if pad == 0:
        return contacts
    return type(contacts)(*[
        torch.nn.functional.pad(getattr(contacts, f), (0, pad))
        for f in contacts._fields])


class BandedOperands(NamedTuple):
    """What the generic banded solve's prologue hands its kernels."""

    contacts: object       # Contacts sorted by rank, compacted, padded
    bases: Tensor          # [Cp / tile] int32 window starts
    la: Tensor             # [Cp] int32 window-local ranks (−1: none)
    lb: Tensor
    cin: Tensor            # [CIN_ROWS, Cp] the constants' contact rows
    tile: int
    use_split: bool        # warm-started
    band_overflow: Tensor  # [] int32 active contacts out of their band
    cap_overflow: Tensor   # [] int32 active contacts beyond capacity


def banded_operands(state: SimState, contacts, cfg: SimConfig,
                    warm: Tuple[Tensor, Tensor] | None,
                    ranks: Tuple[Tensor, Tensor],
                    capacity: int) -> BandedOperands:
    """The prologue of solve_impulses_banded: sort, compaction, band
    check and the warm match (see there)."""
    from physics_tpu_torch.solver.contacts import (
        _field_gather,
        warm_start_lambda_keys,
    )

    n = state.num_bodies
    dev = state.device
    cp = capacity
    tile, wtot, npad = solve_shape(n, cp, cfg)
    lo_all, rb_all = ranks
    c0 = contacts.body_a.shape[0]
    key = torch.where(contacts.active, lo_all, npad - 1)
    sort_idx = torch.argsort(key, stable=True)
    cap_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if c0 > cp:
        cap_overflow = torch.clamp(
            contacts.active.sum() - cp, min=0).to(torch.int32)
        sort_idx = sort_idx[:cp]
    contacts = _pad_contacts(_field_gather(contacts, sort_idx), cp)
    pad = cp - sort_idx.shape[0]
    ra = torch.nn.functional.pad(key[sort_idx], (0, pad), value=npad - 1)
    rb = torch.nn.functional.pad(rb_all[sort_idx], (0, pad), value=-1)
    has_b = contacts.body_b >= 0

    bases = torch.clamp(
        torch.div(ra.reshape(cp // tile, tile).amin(dim=1), 128,
                  rounding_mode="floor") * 128,
        0, npad - wtot).to(torch.int32)
    base = bases.repeat_interleave(tile)
    la = ra - base
    lb = torch.where(has_b, rb - base, -1)
    in_band = (la >= 0) & (la < wtot) & (lb < wtot)
    band_overflow = torch.sum(contacts.active & ~in_band).to(torch.int32)
    live = contacts.active & in_band
    actf = live.to(torch.float32)
    la = torch.where(live, la, -1).to(torch.int32)
    lb = torch.where(live & has_b, lb, -1).to(torch.int32)

    use_split = warm is not None
    zero = torch.zeros((cp,), dtype=torch.float32, device=dev)
    lam0 = (zero, zero, zero)
    if use_split:
        lam0 = tuple(x * actf for x in warm_start_lambda_keys(
            contacts.key, contacts.active, warm, cp))
    has_bf = (has_b & contacts.active & (lb >= 0)).to(torch.float32)
    cin = _cin(contacts.point, contacts.normal, contacts.depth,
               contacts.friction, contacts.restitution, actf, lam0, has_bf)
    return BandedOperands(contacts, bases, la, lb, cin, tile, use_split,
                          band_overflow, cap_overflow)


def solve_impulses_banded(state: SimState, contacts, cfg: SimConfig,
                          order: Tensor | None, geom: Tensor,
                          warm: Tuple[Tensor, Tensor] | None,
                          ranks: Tuple[Tensor, Tensor], capacity: int,
                          plain: bool = False, shard: Shard | None = None,
                          count_band: bool = False):
    """The banded solve of a flat contact list, in the `ranks=` /
    `capacity=` form the generic resolve uses.

    ranks = (lo, rank_b): each contact's endpoint ranks from the broad
    phase (lo the rank of endpoint a, the lower one; rank_b −1 for the
    ground). The contacts are sorted, stably, by lo (inactive last); the
    `capacity` lowest-rank ones are kept and the active contacts beyond
    are counted in `contact_overflow`; the rest pad to capacity. Each tile
    of contacts gets a window of pallas_window ranks from its lowest rank
    (rounded down to 128); a contact whose endpoints leave its window is
    deactivated and counted in `band_overflow`, as the TPU kernel's band
    required. `warm` = (sorted keys [Cp], λ [3, Cp]) of the previous step
    gives matching contacts their λ₀. `geom` is the step's rank-space
    geometry table [48, NPAD] (solve_shape's npad). Then banded_sweeps
    (2.5 with 2.6 in its sweep 0) and the un-permute; with `shard`
    (parallel.collectives.Shard, the whole contact list on every rank) the
    sweeps are banded_sweeps_sharded (2.7), and everything else runs on
    every rank. `count_band` adds band_overflow to tracing's counter
    band_dropped (the generic hull path; nothing while tracing is off).

    Returns (vel, omega, pvel, pomega, lam3, metrics, contacts): the
    sorted, padded contacts whose slots lam3 follows."""
    n = state.num_bodies
    _, _, npad = solve_shape(n, capacity, cfg)
    if geom.shape != (48, npad):
        raise ValueError(f"geom must be [48, {npad}]")
    tracing.stage("solve", geom.device)
    ops = banded_operands(state, contacts, cfg, warm, ranks, capacity)
    if count_band:
        tracing.count("band_dropped", ops.band_overflow)
    kw = dict(tile=ops.tile, vel_iters=cfg.contact_iters,
              pos_iters=cfg.position_iters if ops.use_split else 0,
              plain=plain, **prep_kw(cfg, ops.use_split))
    args = (banded_z0(geom), ops.bases, ops.la, ops.lb, geom, ops.cin)
    if shard is not None:
        z, lam4 = banded_sweeps_sharded(*args, shard=shard, **kw)
    else:
        z, lam4, _ = banded_sweeps(*args, **kw)

    tracing.stage("writeback", geom.device)
    zz = _unpermute(z, order, n)
    lam3 = lam4[:3].contiguous()
    metrics: Dict[str, Tensor] = {}
    if metrics_wanted():
        act = ops.contacts.active
        depth = ops.contacts.depth
        metrics = {
            "contact_count": act.sum().to(torch.int32),
            "max_penetration": torch.clamp(torch.max(torch.where(
                act, depth, torch.zeros_like(depth))), min=0.0),
            "normal_impulse_sum": torch.sum(lam3[0]),
            "band_overflow": ops.band_overflow,
            "contact_overflow": ops.cap_overflow,
        }
    return (zz[0:3].T.contiguous(), zz[3:6].T.contiguous(),
            zz[8:11].T.contiguous(), zz[11:14].T.contiguous(), lam3,
            metrics, ops.contacts)


# ---------------------------------------------------------------------------
# the table-path solve (contacts_pallas.solve_impulses_table)
# ---------------------------------------------------------------------------

def table_solve_operands(table: Tensor, warm_rows: Tensor | None, n: int,
                         cfg: SimConfig):
    """The unfused table solve's operands: (bases [NB] int32, the static
    b·128 window starts; la/lb [Cp] int32 window-local endpoint ranks;
    cin [CIN_ROWS, Cp], λ₀ from warm_rows (None: zero))."""
    nb, ccap, cp = table_shape(n, cfg)
    wtot, npad = geom_pad(n, cfg)
    dev = table.device
    act = table[CT_ACT] > 0.0
    bases = torch.clamp(torch.arange(nb, dtype=torch.int32, device=dev)
                        * BLOCK, 0, npad - wtot).to(torch.int32)
    base = bases.repeat_interleave(ccap)
    has_b = act & (table[CT_RB1] > 0.0)
    ra = table[CT_RA].to(torch.int32)
    rb1 = table[CT_RB1].to(torch.int32)
    la = torch.where(act, ra - base, -1).to(torch.int32)
    lb = torch.where(has_b, rb1 - 1 - base, -1).to(torch.int32)
    zero = torch.zeros((cp,), dtype=torch.float32, device=dev)
    lam0 = list(warm_rows[0:3]) if warm_rows is not None else [zero] * 3
    cin = _cin(table[CT_PT:CT_PT + 3], table[CT_N:CT_N + 3], table[CT_D],
               table[CT_MU], table[CT_REST], table[CT_ACT], lam0,
               has_b.to(torch.float32))
    return bases, la, lb, cin


def solve_impulses_table(state: SimState, table: Tensor, cfg: SimConfig,
                         order: Tensor, warm_rows: Tensor | None,
                         geom: Tensor, fuse: bool, plain: bool = False,
                         shard: Shard | None = None):
    """Banded solve over the bucket-aligned contact table: one tile per
    bucket (ccap contacts), window bases the static b·128. With
    cfg.fuse_prep the fused kernel (2.3) runs the whole solve from the
    table; without, banded_sweeps (2.5, 2.6 in its sweep 0). `fuse` adds
    the integration epilogue. With `shard` (parallel.collectives.Shard,
    the whole table on every rank) the solve is always unfused and has no
    epilogue: banded_sweeps_sharded (2.7, each rank's sweep 0 building the
    constants of its own slots).

    Returns (vel, omega, pvel, pomega, lam3, metrics, keys, posquat):
    body fields in body-id order; pvel/pomega are None when fused, and
    posquat = (pos, quat) only then; `keys` are the table-aligned feature
    keys for the next step's warm match."""
    n = state.num_bodies
    _, ccap, cp = table_shape(n, cfg)
    if table.shape[1] != cp:
        raise ValueError(f"table width {table.shape[1]} != {cp}")
    _, npad = geom_pad(n, cfg)
    if geom.shape != (48, npad):
        raise ValueError(f"geom must be [48, {npad}]")
    tracing.stage("solve", table.device)
    keys = table_keys(table)
    use_split = warm_rows is not None
    integrate = (cfg.dt, cfg.renormalize_quat) if fuse else None
    pos_iters = cfg.position_iters if use_split else 0

    def table_depth():
        """The activity and depth·activity of the table's slots: for the
        metrics only (None, None without them)."""
        if not metrics_wanted():
            return None, None
        act = table[CT_ACT] > 0.0
        return act, torch.where(act, table[CT_D],
                                torch.zeros_like(table[CT_D]))

    if shard is not None and fuse:
        raise ValueError("the sharded table solve has no integration "
                         "epilogue")
    if cfg.fuse_prep and shard is None:
        warm8 = (warm_rows if use_split
                 else torch.zeros((8, cp), dtype=torch.float32,
                                  device=table.device))
        z, lam4, pq = banded_sweeps_fused(
            table, warm8, geom, cfg, vel_iters=cfg.contact_iters,
            pos_iters=pos_iters, use_split=use_split, integrate=integrate,
            plain=plain)
        if cfg.contact_rebuild > 1 and metrics_wanted():
            # anchored refresh: depth·activity re-derived in the kernel
            act, depth_act = lam4[3] > 0.0, lam4[3]
        else:
            act, depth_act = table_depth()
        return _table_solve_outputs(z, lam4, pq, depth_act, act, keys,
                                    order, n)

    act, depth_act = table_depth()
    bases, la, lb, cin = table_solve_operands(table, warm_rows, n, cfg)
    args = (banded_z0(geom), bases, la, lb, geom, cin)
    kw = dict(tile=ccap, vel_iters=cfg.contact_iters, pos_iters=pos_iters,
              plain=plain, **prep_kw(cfg, use_split))
    if shard is not None:
        z, lam4 = banded_sweeps_sharded(*args, shard=shard, **kw)
        return _table_solve_outputs(z, lam4, None, depth_act, act, keys,
                                    order, n)
    posq = None
    if fuse:
        posq = torch.cat([geom[0:3], geom[19:23], torch.zeros_like(
            geom[0:1])])
    z, lam4, pq = banded_sweeps(*args, posq=posq, integrate=integrate, **kw)
    return _table_solve_outputs(z, lam4, pq, depth_act, act, keys, order, n)


def _table_solve_outputs(z, lam4, pq, depth_act, act, keys, order, n):
    """Un-permute the solved rank-space rows to body order, plus the
    solve's metrics (none under metrics_off)."""
    tracing.stage("writeback", z.device)
    fused = pq is not None
    zz = _unpermute(torch.cat([z[0:6], pq[0:7]]) if fused else z, order, n)
    lam3 = lam4[:3].contiguous()
    metrics: Dict[str, Tensor] = {}
    if metrics_wanted():
        metrics = {
            "contact_count": torch.sum(act.to(torch.int32)).to(torch.int32),
            "max_penetration": torch.clamp(torch.max(depth_act), min=0.0),
            "normal_impulse_sum": torch.sum(lam3[0]),
            "band_overflow": torch.zeros((), dtype=torch.int32,
                                         device=z.device),
        }
    vel = zz[0:3].T.contiguous()
    omega = zz[3:6].T.contiguous()
    if fused:
        return (vel, omega, None, None, lam3, metrics, keys,
                (zz[6:9].T.contiguous(), zz[9:13].T.contiguous()))
    return (vel, omega, zz[8:11].T.contiguous(), zz[11:14].T.contiguous(),
            lam3, metrics, keys, None)
