"""The plain reference of the hull step: gravity, the velocity
integration, the anchored hull-table schedule (a rebuild every K-th
step: the sweep sort of the hulls' bounding spheres, the bucketed
candidates, the geometry table in hull mode and the hull contact table;
refreshes between, which keep the persisted table) and the fused solve
with its integration. A frozen copy of the port's plain path
(engine.step with plain=True on the hull table path: ops/forces.py,
ops/integrator.py, solver/contacts.py); it imports nothing of the port.
The box table's pieces it shares (the candidates, the compaction and
warm match, the solve) are reference/table.py's and reference/solve.py's,
the hull table's reference/hull_table.py's.

It has box_step's SNAPSHOT, initial_state, from_snapshot, step(st, cfg,
on_step=None), reset_bodies and held_in, with their meanings, on a scene
of hulls: the arrays carry `hulls`, the one library's fields, and
shapes.hull_index.

Departures from the port's plain step: every body is a movable hull, so
the shape-type tests of the port (boxes, spheres, static bodies) are
left out, and the motion guard (contact_rebuild_vel_factor > 0), which
this configuration turns off, is not copied.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import box_step
from portbench.reference import vec as v3
from portbench.reference.hull_table import (
    bucket_hull_contact_table_plain,
    hull_aabbs,
    hull_geom,
    hull_operands,
)
from portbench.reference.solve import solve_impulses_table
from portbench.reference.state import Config, Shapes, State
from portbench.reference.table import (
    CT2_ROWS,
    bucket_shape,
    bucketed_candidates_plain,
    sweep_order,
    table_shape,
)

Tensor = torch.Tensor

SNAPSHOT = box_step.SNAPSHOT
reset_bodies = box_step.reset_bodies
held_in = box_step.held_in


@dataclasses.dataclass
class HullShapes(Shapes):
    hull_index: Tensor = None    # [N] int32, the body's hull type


@dataclasses.dataclass
class HullState(State):
    hulls: SimpleNamespace = None   # the library's fields [H, ...]


def initial_state(scene: dict, cfg: Config, device) -> HullState:
    """The state of a scene's arrays (pos, quat, mass, inertia, the hulls'
    shapes: params [N, 3] with the bounding radius first, hull_index,
    friction, restitution; the library `hulls`), with the contact
    buffers the anchored path carries, empty."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    sh = scene["shapes"]
    if sh["kind"] != "hull":
        raise ValueError(f"the hull reference has no {sh['kind']!r} shapes")
    mass = np.asarray(scene["mass"], np.float32)
    n = mass.shape[0]
    inv_inertia = np.linalg.inv(np.asarray(scene["inertia"], np.float32))
    pos, quat = t(scene["pos"]), t(scene["quat"])
    cp = table_shape(n, cfg)[2]
    return HullState(
        pos=pos, quat=quat,
        vel=torch.zeros((n, 3), dtype=f32, device=device),
        omega=torch.zeros((n, 3), dtype=f32, device=device),
        mass=t(mass), inv_mass=t((1.0 / mass).astype(np.float32)),
        inv_inertia=t(inv_inertia.astype(np.float32)),
        shapes=HullShapes(t(sh["params"]), t(sh["friction"]),
                          t(sh["restitution"]), t(sh["hull_index"])),
        contact_key=torch.zeros((2, cp), dtype=torch.int32, device=device),
        contact_lam=torch.zeros((3, cp), dtype=f32, device=device),
        contact_table=torch.zeros((CT2_ROWS, cp), dtype=f32, device=device),
        contact_order=torch.arange(n, dtype=torch.int32, device=device),
        contact_meta=torch.zeros((2,), dtype=torch.int32, device=device),
        contact_ref=torch.cat([pos, quat], dim=1),
        step=0,
        hulls=SimpleNamespace(**{k: t(v) for k, v in
                                 scene["hulls"].items()}))


from_snapshot = box_step.from_snapshot


def _rebuild(st: HullState, cfg: Config):
    """Broad phase, geometry table and hull contact table of one rebuild:
    (table, rank order, geom, warm rows, overflow counters, candidates,
    meta)."""
    aabbs = hull_aabbs(st)
    order = sweep_order(st, aabbs)
    n = st.num_bodies
    block, cap, _ = bucket_shape(n, cfg)
    cand = bucketed_candidates_plain(
        order, aabbs.contiguous(), k=min(cfg.sweep_window, n - 1),
        block=block, cap=cap)
    geom = hull_geom(st, cfg, order)
    la, lb, pcols, tc, kw = hull_operands(
        st, cand, cfg, (st.contact_key, st.contact_lam), geom)
    table, meta, warm = bucket_hull_contact_table_plain(geom, la, lb, pcols,
                                                       tc, **kw)
    return (table, order, geom, warm, box_step._overflow(meta, cand), cand,
            meta)


def step(st: HullState, cfg: Config, on_step=None) -> HullState:
    """One step of the hull table path with the anchored schedule
    (contact_rebuild K > 1, fused prep and integration, no motion guard).
    `on_step(st, cfg, s)` is handed, before the solve, what box_step's
    hands it: s["rebuild"], the candidates (None on a refresh), the
    previous keys and impulses, the geometry table, the gate (None), the
    table call's outputs (None on a refresh), and the solve's table, warm
    rows and sweeps."""
    if cfg.contact_rebuild_vel_factor > 0:
        raise ValueError("the hull reference has no motion guard")
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

    # the anchored hull-table schedule (solver/contacts.py)
    n = st.num_bodies
    _, _, cp = table_shape(n, cfg)
    solve_cfg = cfg
    cand = call = None
    rebuild = st.step % cfg.contact_rebuild == 0
    if rebuild:
        table, order, geom, warm, ovf, cand, meta = _rebuild(st, cfg)
        call = (table, meta, warm)
        ref = torch.cat([st.pos, st.quat], dim=1)
    else:
        order = st.contact_order
        geom = hull_geom(st, cfg, order)
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
            rebuild=rebuild, cand=cand, gate=None, geom=geom,
            prev=(st.contact_key, st.contact_lam), table_call=call,
            table=table, warm=warm,
            sweeps=max(solve_cfg.contact_iters,
                       solve_cfg.position_iters) + 1))
    vel, omega, lam3, _, keys, (pos, q) = solve_impulses_table(
        st, table, solve_cfg, order, warm, geom)
    return st.replace(
        vel=vel, omega=omega, pos=pos, quat=q,
        contact_key=keys, contact_lam=lam3, contact_table=table,
        contact_order=order, contact_meta=ovf, contact_ref=ref,
        step=st.step + 1)
