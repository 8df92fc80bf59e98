"""The plain reference of the box step: gravity, the velocity integration,
the anchored contact-table schedule (a rebuild every K-th step: sweep
sort, bucketed candidates or the same-env pairs of packed envs, the
contact table; refreshes between, gated per bucket where
contact_rebuild_vel_factor > 0) and the fused solve with its
integration. A frozen copy of the port's plain path (engine.step with
plain=True on the box table paths: ops/forces.py, ops/integrator.py,
solver/contacts.py); it imports nothing of the port.

It starts from arrays the benchmark makes (`initial_state`) and, to
check a step of the program, from the program's state before that step
(`from_snapshot`): poses, velocities, the warm-start keys and impulses,
the persisted table, rank order, overflow counters and reference poses,
and the step count.

A configuration names its reference module under portbench/reference/
("reference": "box_step"); every such module has SNAPSHOT,
initial_state, from_snapshot, step(st, cfg, on_step=None), reset_bodies
and held_in, with this module's meanings.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import vec as v3
from portbench.reference.solve import solve_impulses_table
from portbench.reference.state import Config, Shapes, State
from portbench.reference.table import (
    BLOCK,
    CT2_ROWS,
    body_aabbs,
    bucket_contact_table_plain,
    bucket_shape,
    bucketed_candidates_plain,
    sweep_order,
    table_operands,
    table_shape,
    unified_geom,
)
from portbench.reference.boxbox import _CAP

Tensor = torch.Tensor

# the fields a snapshot of the program's state hands the reference
SNAPSHOT = ("pos", "quat", "vel", "omega", "contact_key", "contact_lam",
            "contact_table", "contact_order", "contact_meta", "contact_ref")


def initial_state(scene: dict, cfg: Config, device) -> State:
    """The state of a scene's arrays (pos, quat, mass, inertia and the
    boxes' shapes: params, the half extents, friction, restitution; as
    the benchmark made them), with the contact buffers the anchored path
    carries, empty."""
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    sh = scene["shapes"]
    if sh["kind"] != "box":
        raise ValueError(f"the box reference has no {sh['kind']!r} shapes")
    mass = np.asarray(scene["mass"], np.float32)
    n = mass.shape[0]
    inv_inertia = np.linalg.inv(np.asarray(scene["inertia"], np.float32))
    pos, quat = t(scene["pos"]), t(scene["quat"])
    cp = table_shape(n, cfg)[2]
    return State(
        pos=pos, quat=quat,
        vel=torch.zeros((n, 3), dtype=f32, device=device),
        omega=torch.zeros((n, 3), dtype=f32, device=device),
        mass=t(mass), inv_mass=t(1.0 / mass),
        inv_inertia=t(inv_inertia.astype(np.float32)),
        shapes=Shapes(t(sh["params"]), t(sh["friction"]),
                      t(sh["restitution"])),
        contact_key=torch.zeros((2, cp), dtype=torch.int32, device=device),
        contact_lam=torch.zeros((3, cp), dtype=f32, device=device),
        contact_table=torch.zeros((CT2_ROWS, cp), dtype=f32, device=device),
        contact_order=torch.arange(n, dtype=torch.int32, device=device),
        contact_meta=torch.zeros((2,), dtype=torch.int32, device=device),
        contact_ref=torch.cat([pos, quat], dim=1),
        step=0)


def from_snapshot(base: State, snap: dict) -> State:
    """`base`'s bodies with the program's state of a snapshot: the
    SNAPSHOT fields and the step count."""
    return base.replace(step=snap["step"],
                        **{k: snap[k] for k in SNAPSHOT})


def _overflow(meta: Tensor, cand) -> Tensor:
    """[pair_overflow, contact_overflow] of a table."""
    m = meta[0].reshape(-1, BLOCK)
    win = (cand.overflow if cand is not None
           else torch.sum(m[:, 3]).to(torch.int32))
    return torch.stack([win + torch.sum(m[:, 2]).to(torch.int32),
                        torch.sum(m[:, 0]).to(torch.int32)]).to(torch.int32)


def _table(st: State, cand, cfg: Config, geom: Tensor, gate=None):
    """The contact table of `st` from `cand` (None: the in-kernel broad
    phase), warm-matched against st's keys and impulses."""
    la, lb, pcols, kw = table_operands(
        st, cand, cfg, (st.contact_key, st.contact_lam), geom,
        "contact table")
    kw["kk"] = min(cfg.max_contacts_per_pair, _CAP)
    kw["kg"] = min(cfg.max_contacts_per_pair, 8) if cfg.ground_plane else 0
    kw["gate"] = None if gate is None else (
        gate[0].to(torch.int32).contiguous(), gate[1])
    return bucket_contact_table_plain(geom, la, lb, pcols, **kw)


def _rebuild(st: State, cfg: Config):
    """Broad phase, geometry table and contact table of one rebuild:
    (table, rank order or None for the packed envs' identity, geom, warm
    rows, overflow counters, candidates or None, meta)."""
    order = cand = None
    if cfg.broadphase != "env_blocks":
        aabbs = body_aabbs(st)
        order = sweep_order(st, aabbs)
        if not cfg.bp_inkernel:
            n = st.num_bodies
            block, cap, _ = bucket_shape(n, cfg)
            cand = bucketed_candidates_plain(
                order, aabbs.contiguous(), k=min(cfg.sweep_window, n - 1),
                block=block, cap=cap)
    geom = unified_geom(st, cfg, order)
    table, meta, warm = _table(st, cand, cfg, geom)
    return table, order, geom, warm, _overflow(meta, cand), cand, meta


def refresh_gate(st: State, cfg: Config, order: Tensor | None) -> Tensor:
    """The per-bucket displacement gate of a refresh step [NB] bool: each
    body's motion since its bucket's last build (contact_ref), max|Δpos|
    + 2·|Δq|·|half extents|, taken per bucket of ranks and folded with
    the next bucket's, against vel_factor·slop."""
    n = st.num_bodies
    nb = table_shape(n, cfg)[0]
    ref = st.contact_ref
    dp = torch.amax(torch.abs(st.pos - ref[:, 0:3]), dim=1)
    dq2 = torch.minimum(torch.sum((st.quat - ref[:, 3:7]) ** 2, dim=1),
                        torch.sum((st.quat + ref[:, 3:7]) ** 2, dim=1))
    r_body = torch.sqrt(torch.sum(st.shapes.params ** 2, dim=1))
    disp = dp + 2.0 * torch.sqrt(dq2) * r_body
    if order is not None:
        disp = disp[order.long()]
    dmb = torch.amax(torch.nn.functional.pad(
        disp, (0, nb * BLOCK - n)).reshape(nb, BLOCK), dim=1)
    dmb = torch.maximum(dmb, torch.cat([dmb[1:], torch.zeros_like(dmb[:1])]))
    return dmb > cfg.contact_rebuild_vel_factor * cfg.penetration_slop


def _gated_refresh(st: State, cfg: Config, order: Tensor | None,
                   geom: Tensor):
    """The table of a gated refresh step: the fired buckets recompute
    their contacts through the in-kernel broad phase on the persisted
    order, the others pass their persisted block through. Returns
    (table, warm rows, overflow counters, contact_ref, the gate, meta)."""
    n = st.num_bodies
    gate = refresh_gate(st, cfg, order)
    table, meta, warm = _table(st, None, cfg, geom,
                               gate=(gate, st.contact_table))
    ovf = torch.maximum(st.contact_meta, _overflow(meta, None))
    if order is None:
        fired = gate.repeat_interleave(BLOCK)[:n]
    else:
        rank_of = torch.empty((n,), dtype=torch.int64, device=st.device)
        rank_of[order.long()] = torch.arange(n, device=st.device)
        fired = gate[rank_of // BLOCK]
    ref = torch.where(fired[:, None], torch.cat([st.pos, st.quat], dim=1),
                      st.contact_ref)
    return table, warm, ovf, ref, gate, meta


def step(st: State, cfg: Config, on_step=None) -> State:
    """One step of the box table path with the anchored schedule
    (contact_rebuild K > 1, fused prep and integration). `on_step(st,
    cfg, s)` is handed, before the solve, what the step's inputs make
    the table and the solve do (for the rooflines): s["rebuild"], the
    broad phase's candidates (None without), the previous keys and
    impulses, the geometry table, the gate (None ungated), the table
    call's outputs (None where the step calls no table), and the solve's
    table, warm rows and sweeps."""
    dt = cfg.dt
    # gravity (ops/forces.py), then the velocity integration
    # (ops/integrator.py, non-compat, no gyroscopic term or clamp)
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
    st = st.replace(vel=vel, omega=omega)

    # the anchored contact-table schedule (solver/contacts.py)
    n = st.num_bodies
    _, _, cp = table_shape(n, cfg)
    env = cfg.broadphase == "env_blocks"
    solve_cfg = cfg
    gate = cand = call = None
    rebuild = st.step % cfg.contact_rebuild == 0
    if rebuild:
        table, order, geom, warm, ovf, cand, meta = _rebuild(st, cfg)
        call = (table, meta, warm)
        ref = torch.cat([st.pos, st.quat], dim=1)
    else:
        order = None if env else st.contact_order
        geom = unified_geom(st, cfg, order)
        if cfg.contact_rebuild_vel_factor > 0:
            table, warm, ovf, ref, gate, meta = _gated_refresh(
                st, cfg, order, geom)
            call = (table, meta, warm)
        else:
            table = st.contact_table
            warm = torch.cat([st.contact_lam, torch.zeros(
                (5, cp), dtype=torch.float32, device=st.device)])
            ovf = st.contact_meta
            ref = st.contact_ref
        r_it = cfg.contact_refresh_iters
        if 0 < r_it < cfg.contact_iters:
            solve_cfg = cfg.replace(
                contact_iters=r_it,
                position_iters=min(cfg.position_iters, r_it))
    if on_step is not None:
        on_step(st, solve_cfg, dict(
            rebuild=rebuild, cand=cand, gate=gate, geom=geom,
            prev=(st.contact_key, st.contact_lam), table_call=call,
            table=table, warm=warm,
            sweeps=max(solve_cfg.contact_iters,
                       solve_cfg.position_iters) + 1))
    vel, omega, lam3, _, keys, (pos, q) = solve_impulses_table(
        st, table, solve_cfg, order, warm, geom)
    return st.replace(
        vel=vel, omega=omega, pos=pos, quat=q,
        contact_key=keys, contact_lam=lam3, contact_table=table,
        contact_order=st.contact_order if env else order,
        contact_meta=ovf, contact_ref=ref, step=st.step + 1)


def reset_bodies(st: State, idx: Tensor, pos: Tensor, quat: Tensor
                 ) -> State:
    """Bodies `idx` placed at pos/quat at rest (an env's reset)."""
    z = torch.zeros((idx.shape[0], 3), dtype=torch.float32,
                    device=st.device)
    return st.replace(
        pos=st.pos.index_copy(0, idx, pos),
        quat=st.quat.index_copy(0, idx, quat),
        vel=st.vel.index_copy(0, idx, z),
        omega=st.omega.index_copy(0, idx, z))


def held_in(st: State, dtype: torch.dtype) -> State:
    """st with its poses, velocities and impulses rounded to `dtype` and
    back (the control: a state held in a lower precision between
    steps)."""
    def r(t):
        return t.to(dtype).to(torch.float32)

    return st.replace(pos=r(st.pos), quat=r(st.quat), vel=r(st.vel),
                      omega=r(st.omega), contact_lam=r(st.contact_lam))

