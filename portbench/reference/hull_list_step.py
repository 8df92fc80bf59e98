"""The plain reference of the generic hull path's step (rain_xla_config):
gravity, the velocity integration, the contact list (reference/
hull_list.py: hull AABBs, the sweep order, the flat window masks and
compact_pairs, the geometry table in hull mode, the hull vertices on the
ground, the OBB prefilter, the slot-major SAT manifolds and their kk
argmax picks), the banded solve's operands (the sort by rank, the tile
bases, the band check, the warm match by key), 2.6's constants and 2.5's
Jacobi sweeps, the split-impulse pose update, the warm keys sorted with
their λ, then the position integration. A rebuild every step: no
anchoring, no fused integration. A frozen copy of the port's plain path
(engine.step with plain=True under rain_xla_config: ops/forces.py,
ops/integrator.py, solver/contacts.py's _resolve_contacts_banded,
solver/banded_solve.py's banded_operands, prep_consts_plain and
banded_sweeps_plain); it imports nothing of the port. The constants'
math, the sweeps and the un-permute are reference/solve.py's; the state
and the hull library reference/hull_step.py's.

It has box_step's interface (initial_state, from_snapshot, step(st, cfg,
on_step=None), reset_bodies, held_in) on a scene of hulls, with the
fields this path carries (SNAPSHOT). The keys are carried as [1, C] (the
port's are [C]), so that the check (core/check.state_gaps) counts the
slots whose keys differ.

Departures from the port's plain step: every body is a hull (the shape
tests read as true), the scene has pairs (N > 1) and no joints, the
solve's metrics are not computed, and the pair-contact departures of
reference/hull_list.py. The deltas of a sweep are summed with
index_add, in another order than the port's kernel's atomics: results
agree to rounding.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch

from portbench.reference import box_step
from portbench.reference import hull_step
from portbench.reference import vec as v3
from portbench.reference.hull_list import (
    Contacts,
    contact_capacity,
    contact_list,
    solve_shape,
)
from portbench.reference.solve import (
    Z_ROWS,
    _gather,
    _prep_consts_math,
    _sweep_loop,
    _unpermute,
)
from portbench.reference.state import Config

Tensor = torch.Tensor

SNAPSHOT = ("pos", "quat", "vel", "omega", "contact_key", "contact_lam")
reset_bodies = box_step.reset_bodies
held_in = box_step.held_in


def initial_state(scene: dict, cfg: Config, device) -> hull_step.HullState:
    """The state of a scene's arrays (reference/hull_step.initial_state's
    bodies and library) with this path's warm buffers, empty: keys [1, C]
    and impulses [3, C], C the solve's contact slots."""
    st = hull_step.initial_state(scene, cfg, device)
    cp = contact_capacity(st, cfg)
    return st.replace(
        contact_key=torch.zeros((1, cp), dtype=torch.int32, device=device),
        contact_lam=torch.zeros((3, cp), dtype=torch.float32, device=device),
        contact_table=torch.zeros((0, cp), dtype=torch.float32,
                                  device=device))


def from_snapshot(base, snap: dict):
    """`base`'s bodies with the program's state of a snapshot: the
    SNAPSHOT fields and the step count."""
    return base.replace(step=snap["step"], **{k: snap[k] for k in SNAPSHOT})


def _forces(st, cfg):
    """Gravity (ops/forces.py), then the velocity integration
    (ops/integrator.py, non-compat, no gyroscopic term or clamp)."""
    dt = cfg.dt
    f = torch.stack([st.mass * g for g in cfg.gravity], dim=1)
    f = torch.where((st.inv_mass > 0.0)[:, None], f, torch.zeros_like(f))
    vel = st.vel + f * (st.inv_mass[:, None] * dt)
    rot = v3.qmatrix(st.quat)
    torque = torch.zeros_like(st.omega)

    def mv(m, v):
        return torch.sum(m * v[:, None, :], dim=-1)

    def mtv(m, v):
        return torch.sum(m * v[:, :, None], dim=-2)

    omega = st.omega + mv(rot, mv(st.inv_inertia, mtv(rot, torque * dt)))
    return st.replace(vel=vel, omega=omega)


def warm_start_lambda_keys(keys: Tensor, active: Tensor,
                           warm: Tuple[Tensor, Tensor], c: int):
    """The previous step's impulses matched to this step's keys: one
    stable sort of key·2 + tag (previous 0, current 1); a current entry
    whose predecessor is the previous entry with its key takes that λ.
    Returns (λn, λt1, λt2) [c], zero on inactive or unkeyed contacts."""
    prev_keys, prev_lam = warm
    kp = prev_keys.shape[0]
    dev = keys.device
    tag = torch.cat([torch.zeros((kp,), dtype=torch.int32, device=dev),
                     torch.ones((c,), dtype=torch.int32, device=dev)])
    comb = torch.cat([prev_keys, keys]) * 2 + tag
    sk2, perm = torch.sort(comb, stable=True)
    st = tag[perm]
    prev_tag = torch.cat([st.new_ones((1,)), st[:-1]])
    prev_sk2 = torch.cat([sk2[:1] - 2, sk2[:-1]])
    match = (st == 1) & (prev_tag == 0) & (sk2 == prev_sk2 + 1) & (sk2 != 1)
    zc = torch.zeros((3, c), dtype=torch.float32, device=dev)
    pl = torch.cat([prev_lam, zc], dim=1)[:, perm]
    pred = torch.cat([pl[:, :1], pl[:, :-1]], dim=1) * match.to(
        torch.float32)
    slot = torch.where(st == 1, perm - kp, c)
    out = torch.empty((3, c + 1), dtype=torch.float32, device=dev)
    out[:, slot] = pred
    actf = (active & (keys != 0)).to(torch.float32)
    return out[0, :c] * actf, out[1, :c] * actf, out[2, :c] * actf


def _field_gather(contacts: Contacts, idx: Tensor) -> Contacts:
    return Contacts(*[
        getattr(contacts, f)[:, idx] if f in ("point", "normal")
        else getattr(contacts, f)[idx] for f in Contacts._fields])


def _pad_contacts(contacts: Contacts, cp: int) -> Contacts:
    """Every field zero-padded to cp slots (inactive, key 0)."""
    pad = cp - contacts.body_a.shape[0]
    if pad == 0:
        return contacts
    return Contacts(*[torch.nn.functional.pad(getattr(contacts, f), (0, pad))
                      for f in Contacts._fields])


def banded_operands(st, contacts: Contacts, cfg, warm, ranks, cp: int
                    ) -> SimpleNamespace:
    """The banded solve's prologue: the contacts sorted stably by the rank
    of endpoint a (inactive last), the cp lowest kept and padded; each
    tile's window from its lowest rank rounded down to 128; a contact
    whose endpoints leave its window deactivated (band_overflow); the
    warm match. Returns the sorted contacts, bases, la, lb, cin, tile,
    use_split and band_overflow."""
    n = st.num_bodies
    dev = st.device
    tile, wtot, npad = solve_shape(n, cp, cfg)
    lo_all, rb_all = ranks
    c0 = contacts.body_a.shape[0]
    key = torch.where(contacts.active, lo_all, npad - 1)
    sort_idx = torch.argsort(key, stable=True)
    if c0 > cp:
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
    cin = torch.stack([*contacts.point, *contacts.normal, contacts.depth,
                       contacts.friction, contacts.restitution, actf, *lam0,
                       has_bf])
    return SimpleNamespace(contacts=contacts, bases=bases, la=la, lb=lb,
                           cin=cin, tile=tile, use_split=use_split,
                           band_overflow=band_overflow)


def win_rank(bases: Tensor, loc: Tensor, tile: int) -> Tensor:
    """Each slot's rank from its window-local index (−1: none)."""
    base = bases.to(torch.int64).repeat_interleave(tile)
    return torch.where(loc >= 0, base + loc.to(torch.int64), -1)


def prep_consts(geom: Tensor, ops, cfg) -> Tensor:
    """2.6's constants [45, Cp] of every slot (prep_consts_plain)."""
    ga = _gather(geom[0:24], win_rank(ops.bases, ops.la, ops.tile))
    gb = _gather(geom[0:24], win_rank(ops.bases, ops.lb, ops.tile))
    cin = ops.cin
    cs = _prep_consts_math(
        ga, gb, (cin[0], cin[1], cin[2]), (cin[3], cin[4], cin[5]), cin[6],
        cin[7], cin[8], cin[9], (cin[10], cin[11], cin[12]), cin[13],
        baum_over_dt=cfg.baumgarte / cfg.dt, slop=cfg.penetration_slop,
        relaxation=cfg.contact_relaxation, use_split=ops.use_split)
    return torch.stack(cs)


def _split_impulse_pose(st, cfg, pvel: Tensor, pomega: Tensor):
    pos = st.pos + pvel * cfg.dt
    dq = v3.qexp(pomega * cfg.dt)
    return pos, v3.qnormalize(v3.qmul(dq, st.quat))


def step(st, cfg: Config, on_step=None):
    """One step of the generic hull path. `on_step(st, cfg, s)`, when
    given, is handed before the sweeps s["banded"] (the solve's operands,
    with `consts`, 2.6's constants of every slot), s["geom"] and
    s["sweeps"]."""
    n = st.num_bodies
    st = _forces(st, cfg)
    contacts, ranks, order, geom, _, cp, _ = contact_list(st, cfg)
    warm = (st.contact_key.reshape(-1), st.contact_lam)
    ops = banded_operands(st, contacts, cfg, warm, ranks, cp)
    vel_iters = cfg.contact_iters
    pos_iters = cfg.position_iters if ops.use_split else 0
    sweeps = max(vel_iters, pos_iters) + 1
    consts = prep_consts(geom, ops, cfg)
    if on_step is not None:
        ops.consts = consts
        on_step(st, cfg, dict(banded=ops, geom=geom, sweeps=sweeps))
    z = torch.zeros((Z_ROWS, geom.shape[1]), dtype=torch.float32,
                    device=st.device)
    z[0:6] = geom[13:19]
    lam = _sweep_loop(z, consts, win_rank(ops.bases, ops.la, ops.tile),
                      win_rank(ops.bases, ops.lb, ops.tile),
                      n_sweeps=sweeps, vel_iters=vel_iters,
                      pos_iters=pos_iters, warm=ops.use_split)
    zz = _unpermute(z, order, n)
    lam3 = torch.stack(lam)[:3].contiguous()
    pos, q = _split_impulse_pose(st, cfg, zz[8:11].T.contiguous(),
                                 zz[11:14].T.contiguous())
    key_s, perm = torch.sort(ops.contacts.key, stable=True)
    vel, omega = zz[0:3].T.contiguous(), zz[3:6].T.contiguous()
    # the position integration (ops/integrator.integrate_positions)
    q = v3.qmul(v3.qexp(omega * cfg.dt), q)
    if cfg.renormalize_quat:
        q = v3.qnormalize(q)
    return st.replace(pos=pos + vel * cfg.dt, quat=q, vel=vel, omega=omega,
                      contact_key=key_s[None],
                      contact_lam=lam3[:, perm].contiguous(),
                      step=st.step + 1)

