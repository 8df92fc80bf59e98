"""Contact dispatch and the anchored rebuild/refresh schedule
(physics_tpu/solver/contacts.py: `table_path`, `hull_table_path`,
`anchored_path`, `fused_integration`, `contact_capacity`,
`resolve_contacts`, `_resolve_contacts_table`).

The two bucket-aligned contact-table paths are ported: boxes (box contact
table) and hulls (hull contact table). With cfg.contact_rebuild = K > 1
(anchored path), every K-th step REBUILDS: sweep sort, bucketed
candidates, geometry table, contact-table kernel, full solve schedule. The other steps REFRESH: the persisted table and
rank order are kept, the solve's sweep 0 re-derives every contact from
its body-frame anchors, and the schedule is contact_refresh_iters sweeps.
The branch depends only on the step count, so the host picks it from
its mirror of step_count — no device sync.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.ops.broadphase import (
    body_aabbs,
    pair_candidates,
    sweep_order,
)
from physics_tpu_torch.ops.contact_table import (
    CT2_ROWS,
    BLOCK,
    bucket_contact_table,
    table_shape,
    unified_geom,
)
from physics_tpu_torch.ops.hull_table import (
    MAX_TABLE_HULL_TYPES,
    bucket_hull_contact_table,
)
from physics_tpu_torch.ops.narrowphase import hulls_fast_path
from physics_tpu_torch.solver.banded_solve import solve_impulses_table
from physics_tpu_torch.state import SimState

Tensor = torch.Tensor


def table_path(state: SimState, cfg: SimConfig) -> bool:
    """True when the step routes through the bucket-aligned box contact
    table (the bucketed sweep feeding it; env_blocks is ROADMAP item
    1.10)."""
    return bool(
        cfg.contact_solver == "pallas_banded" and cfg.contact_table
        and cfg.boxes_only and cfg.pair_collisions
        and state.num_bodies > 1
        and cfg.broadphase == "sweep" and cfg.pair_buckets)


def hull_table_path(state: SimState, cfg: SimConfig) -> bool:
    """True when the step routes through the fused HULL contact table
    (ops/hull_table.py), the hulls-only analogue of table_path: the
    bucketed sweep, the shared-hull fast layout and a library of at most
    MAX_TABLE_HULL_TYPES hull types. Depends on cfg and shapes only."""
    return bool(
        cfg.contact_solver == "pallas_banded" and cfg.contact_table
        and cfg.hull_table and cfg.pair_collisions
        and cfg.broadphase == "sweep" and cfg.pair_buckets
        and state.num_bodies > 1 and not cfg.bp_inkernel
        and hulls_fast_path(state, cfg)
        and state.hulls.verts.shape[0] <= MAX_TABLE_HULL_TYPES)


def anchored_path(state: SimState, cfg: SimConfig) -> bool:
    """True when contact_rebuild > 1 engages the persistent anchored
    contacts: a table path with fuse_prep, candidates built outside the
    table kernel. Anchors are a contact point and normal in body frames,
    whatever the shapes, so the hull table shares the box table's
    anchored refresh."""
    if not (cfg.contact_rebuild > 1 and cfg.fuse_prep):
        return False
    return hull_table_path(state, cfg) or (
        table_path(state, cfg) and not cfg.bp_inkernel)


def fused_integration(state: SimState, cfg: SimConfig) -> bool:
    """True when the solve's epilogue integrates pos/quat."""
    return cfg.fuse_integrate and not cfg.compat and (
        table_path(state, cfg) or hull_table_path(state, cfg))


def contact_capacity(state: SimState, cfg: SimConfig) -> int:
    """Contact-slot count of one step (the table width)."""
    if not (table_path(state, cfg) or hull_table_path(state, cfg)):
        raise NotImplementedError(
            "only the contact-table paths are ported; the generic contact "
            "paths are ROADMAP item 1.13")
    return table_shape(state.num_bodies, cfg)[2]


def _check_ported(state: SimState, cfg: SimConfig) -> None:
    if cfg.compat:
        raise NotImplementedError("compat mode is ROADMAP item 1.11")
    if cfg.broadphase == "env_blocks" or cfg.bp_inkernel:
        raise NotImplementedError(
            "env_blocks and the in-kernel broad phase are ROADMAP item 1.10")
    hulls = hull_table_path(state, cfg)
    if not (table_path(state, cfg) or hulls):
        raise NotImplementedError(
            "only the contact-table paths are ported; the generic contact "
            "paths are ROADMAP item 1.13")
    if not (cfg.fuse_prep and fused_integration(state, cfg)):
        raise NotImplementedError(
            "only the fused-prep solve with fused integration is ported; "
            "the unfused table solve is ROADMAP kernels 2.5/2.6")
    if cfg.contact_rebuild > 1 and cfg.contact_rebuild_vel_factor > 0:
        if hulls:
            raise NotImplementedError(
                "the hull path's global motion guard "
                "(contact_rebuild_vel_factor > 0) is ROADMAP item 1.12")
        raise NotImplementedError(
            "the per-bucket displacement gate (contact_rebuild_vel_factor "
            "> 0) is ROADMAP item 1.10")


def resolve_contacts(state: SimState, cfg: SimConfig,
                     plain: bool = False) -> Tuple[SimState, Dict]:
    """Broad phase → contact table → banded solve (+ integration).
    `plain=True` runs every kernel's plain version (on any device) — the
    reference the kernel path is checked against on the card."""
    if cfg.contact_rebuild > 1 and not anchored_path(state, cfg):
        cfg = cfg.replace(contact_rebuild=1)
    _check_ported(state, cfg)
    return _resolve_contacts_table(state, cfg, plain)


def _rebuild(st: SimState, cfg: SimConfig, use_warm: bool, plain: bool):
    aabbs = body_aabbs(st)
    order = sweep_order(st, aabbs)
    cand = pair_candidates(st, cfg, aabbs=aabbs, order=order, plain=plain)
    hulls = hull_table_path(st, cfg)
    geom = unified_geom(st, cfg, order, hulls=hulls)
    prev = (st.contact_key, st.contact_lam) if use_warm else None
    table_fn = bucket_hull_contact_table if hulls else bucket_contact_table
    table, meta, warm = table_fn(st, cand, cfg, prev=prev, geom=geom,
                                 plain=plain)
    m = meta[0].reshape(-1, BLOCK)
    ovf = torch.stack([
        cand.overflow + torch.sum(m[:, 2]).to(torch.int32),
        torch.sum(m[:, 0]).to(torch.int32),
    ]).to(torch.int32)
    return table, order, geom, warm, ovf


def _resolve_contacts_table(state: SimState, cfg: SimConfig,
                            plain: bool) -> Tuple[SimState, Dict]:
    n = state.num_bodies
    nb, ccap, cp = table_shape(n, cfg)
    use_warm = tuple(state.contact_key.shape) == (2, cp)

    if cfg.contact_rebuild > 1:
        if (tuple(state.contact_table.shape) != (CT2_ROWS, cp)
                or state.contact_order.shape[0] != n or not use_warm):
            raise ValueError(
                "cfg.contact_rebuild > 1 needs the persisted-table "
                "buffers — call engine.prepare_contacts(state, cfg)")
        solve_cfg = cfg
        if state.step_count_host % cfg.contact_rebuild == 0:
            table, order, geom, warm, ovf = _rebuild(state, cfg, True,
                                                     plain)
            ref = torch.cat([state.pos, state.quat], dim=1)
        else:
            order = state.contact_order
            table = state.contact_table
            geom = unified_geom(state, cfg, order,
                                hulls=hull_table_path(state, cfg))
            warm = torch.cat([state.contact_lam, torch.zeros(
                (5, cp), dtype=torch.float32, device=state.device)])
            ovf = state.contact_meta
            ref = state.contact_ref
            r_it = cfg.contact_refresh_iters
            if 0 < r_it < cfg.contact_iters:
                solve_cfg = cfg.replace(
                    contact_iters=r_it,
                    position_iters=min(cfg.position_iters, r_it))
        vel, omega, lam3, solve_metrics, keys, (pos, quat) = \
            solve_impulses_table(state, table, solve_cfg, order, warm, geom,
                                 plain=plain)
        state = state.replace(
            vel=vel, omega=omega, pos=pos, quat=quat,
            contact_key=keys, contact_lam=lam3, contact_table=table,
            contact_order=order, contact_meta=ovf, contact_ref=ref)
        return state, {"pair_overflow": ovf[0], "contact_overflow": ovf[1],
                       **solve_metrics}

    # K = 1: rebuild every step
    table, order, geom, warm, ovf = _rebuild(state, cfg, use_warm, plain)
    vel, omega, lam3, solve_metrics, keys, (pos, quat) = \
        solve_impulses_table(state, table, cfg, order, warm, geom,
                             plain=plain)
    state = state.replace(vel=vel, omega=omega, pos=pos, quat=quat)
    if use_warm:
        state = state.replace(contact_key=keys, contact_lam=lam3)
    return state, {"pair_overflow": ovf[0], "contact_overflow": ovf[1],
                   **solve_metrics}
