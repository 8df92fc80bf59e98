"""Contact dispatch and the anchored rebuild/refresh schedule
(physics_tpu/solver/contacts.py: `table_path`, `hull_table_path`,
`anchored_path`, `fused_integration`, `contact_capacity`,
`warm_start_lambda_keys`, `_field_gather`, `resolve_contacts`,
`_resolve_contacts_table`).

Three paths are ported. The two bucket-aligned contact-table paths:
boxes (box contact table: candidates from the bucketed sweep, from the
table kernel's own broad phase with bp_inkernel, or, for packed
environments, broadphase="env_blocks", from its same-env pairs under the
identity order, with no sort) and hulls (hull contact table), each with
the fused-prep solve or, with fuse_prep off, the unfused one. And the
generic banded branch for boxes (the two-kernel pile): box ground
corners and the banded pair manifolds give a flat contact list, which
the banded solve sorts by rank, compacts, warm-starts by feature key and
solves (banded_sweeps, whose sweep 0 builds the constants); the
split-impulse pseudo velocities move the poses right after. With
cfg.contact_rebuild = K > 1 (anchored path), every K-th step REBUILDS:
sweep sort, bucketed candidates, geometry table, contact-table kernel,
full solve schedule.
The other steps REFRESH: the persisted table and rank order are kept,
the solve's sweep 0 re-derives every contact from its body-frame
anchors, and the schedule is contact_refresh_iters sweeps. With
contact_rebuild_vel_factor > 0 a box table's refresh is GATED: the
buckets whose bodies moved more than vel_factor·slop since their last
build recompute their contacts (the table kernel's gate mode), the rest
pass their persisted block through. The branch depends only on the step
count, so the host picks it from its mirror of step_count — no device
sync — except on a hull table path with vel_factor > 0, whose global
motion guard also rebuilds off the schedule: an eager step reads its
predicate back; engine.DeviceStepper decides it on the device
(rebuild_branch's GUARDED: a graph that holds both branches behind
conditional nodes on the predicate).

With `shard` (parallel.collectives.Shard, the row-sharded step) every rank
holds the whole state and the contact work is split by rank: on the
table paths each rank builds the table of its own bucket range and the
ranks all-gather it; on the generic branch each rank computes the ground
corners and pair manifolds of its slice of the contact slots and the
ranks all-gather the contacts back into the one-process order. The
solve's sweeps are split by rank too (banded_sweeps_sharded); the rest
runs on every rank. Under `shard` contact_rebuild is 1 and the solve has
no integration epilogue.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import quaternion as quat
from physics_tpu_torch.ops.boxbox_batched import _CAP
from physics_tpu_torch.ops.broadphase import (
    PairCandidates,
    body_aabbs,
    bucket_shape,
    pair_candidates,
    sweep_order,
)
from physics_tpu_torch.ops.contact_table import (
    CT2_ROWS,
    BLOCK,
    _BOX_SIGNS,
    bucket_contact_table,
    table_shape,
    unified_geom,
)
from physics_tpu_torch.ops.hull_table import (
    MAX_TABLE_HULL_TYPES,
    bucket_hull_contact_table,
)
from physics_tpu_torch.ops.narrowphase import (
    Contacts,
    banded_contacts,
    banded_pairs,
    concat_contacts,
    hulls_fast_path,
)
from physics_tpu_torch.parallel.collectives import Shard, all_gather_last
from physics_tpu_torch.solver.banded_solve import (
    padded_contact_count,
    solve_impulses_banded,
    solve_impulses_table,
    solve_shape,
)
from physics_tpu_torch.state import SimState

Tensor = torch.Tensor


def table_path(state: SimState, cfg: SimConfig) -> bool:
    """True when the step routes through the bucket-aligned box contact
    table: fed by the bucketed sweep, or by packed envs (env_blocks with
    the in-kernel broad phase, K | 128 and K | N)."""
    if not (cfg.contact_solver == "pallas_banded" and cfg.contact_table
            and cfg.boxes_only and cfg.pair_collisions
            and state.num_bodies > 1):
        return False
    if cfg.broadphase == "sweep":
        return bool(cfg.pair_buckets)
    if cfg.broadphase == "env_blocks":
        k = cfg.env_block_size
        return bool(cfg.bp_inkernel and k > 1 and 128 % k == 0
                    and state.num_bodies % k == 0)
    return False


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
    contacts: a table path with fuse_prep — the hull table, the box table
    on the bucketed sweep without bp_inkernel, or the box table of packed
    envs (env_blocks). Anchors are a contact point and normal in body
    frames, whatever the shapes, so the hull table shares the box table's
    anchored refresh."""
    if not (cfg.contact_rebuild > 1 and cfg.fuse_prep):
        return False
    if hull_table_path(state, cfg):
        return True
    if not table_path(state, cfg):
        return False
    return cfg.broadphase == "env_blocks" or not cfg.bp_inkernel


def fused_integration(state: SimState, cfg: SimConfig,
                      shard: Shard | None = None) -> bool:
    """True when the solve's epilogue integrates pos/quat (never under
    `shard`: the sharded solve has no epilogue)."""
    return shard is None and cfg.fuse_integrate and not cfg.compat and (
        table_path(state, cfg) or hull_table_path(state, cfg))


def banded_boxes_path(state: SimState, cfg: SimConfig) -> bool:
    """True when the step takes the generic banded branch the port
    carries: boxes only, the banded solve without a contact table, and
    pairs (if any) through the bucketed sweep and the banded
    pair-manifold kernel. Depends on cfg and shapes only."""
    if table_path(state, cfg) or hull_table_path(state, cfg):
        return False
    if not (cfg.contact_solver == "pallas_banded" and cfg.boxes_only):
        return False
    return not (cfg.pair_collisions and state.num_bodies > 1) or \
        banded_pairs(cfg)


def _unported_generic():
    return NotImplementedError(
        "only the contact-table paths and the generic banded box path are "
        "ported; the other generic contact paths are ROADMAP item 1.13")


def contact_capacity(state: SimState, cfg: SimConfig) -> int:
    """Contact-slot count of one step: the table width on the table
    paths; on the generic banded path the ground corners (k·N) plus the
    pair slots (kk·P), capped at max_contacts and padded to the solve
    tile."""
    n = state.num_bodies
    if table_path(state, cfg) or hull_table_path(state, cfg):
        return table_shape(n, cfg)[2]
    if not banded_boxes_path(state, cfg):
        raise _unported_generic()
    c = 0
    if cfg.ground_plane:
        c += min(cfg.max_contacts_per_pair, len(_BOX_SIGNS)) * n
    if cfg.pair_collisions and n > 1:
        block, cap, n_blocks = bucket_shape(n, cfg)
        c += min(cfg.max_contacts_per_pair, _CAP) * n_blocks * cap
    if cfg.max_contacts > 0:
        c = min(c, cfg.max_contacts)
    return padded_contact_count(n, c, cfg)


def _check_ported(state: SimState, cfg: SimConfig) -> None:
    if cfg.compat:
        raise NotImplementedError(
            "compat mode together with contacts (the JAX package integrates "
            "it unfused there) is ROADMAP item 1.11b")
    if not (table_path(state, cfg) or hull_table_path(state, cfg)
            or banded_boxes_path(state, cfg)):
        raise _unported_generic()


def resolve_contacts(state: SimState, cfg: SimConfig,
                     plain: bool = False,
                     shard: Shard | None = None) -> Tuple[SimState, Dict]:
    """Broad phase → narrow phase → banded solve (+ integration).
    `plain=True` runs every kernel's plain version (on any device) — the
    reference the kernel path is checked against on the card. `shard`
    splits the contact work over the ranks (see the module docstring)."""
    if cfg.contact_rebuild > 1 and (shard is not None
                                    or not anchored_path(state, cfg)):
        # the anchored pipeline engages on the unsharded table paths only
        cfg = cfg.replace(contact_rebuild=1)
    _check_ported(state, cfg)
    if table_path(state, cfg) or hull_table_path(state, cfg):
        return _resolve_contacts_table(state, cfg, plain, shard)
    return _resolve_contacts_banded(state, cfg, plain, shard)


def _split_impulse_pose(state: SimState, cfg: SimConfig, pvel: Tensor,
                        pomega: Tensor) -> Tuple[Tensor, Tensor]:
    """The split-impulse position correction: the pseudo velocities move
    the pose at once and never enter the momentum state."""
    pos = state.pos + pvel * cfg.dt
    dq = quat.exp_map(pomega * cfg.dt)
    return pos, quat.normalize(quat.mul(dq, state.quat))


def warm_start_lambda_keys(keys: Tensor, active: Tensor,
                           warm: Tuple[Tensor, Tensor], c: int):
    """Match the previous step's impulses to this step's contact keys:
    one stable sort of the previous and current keys, packed as
    key·2 + tag (previous 0, current 1) so each previous entry lands just
    before the current entry with the same key; a current entry whose
    predecessor is that previous entry takes its λ. Returns (λn, λt1,
    λt2) [c], zero on inactive or unkeyed contacts."""
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
    # predecessor's payload: the matching previous entry's λ
    pred = torch.cat([pl[:, :1], pl[:, :-1]], dim=1) * match.to(
        torch.float32)
    # delivery: current entries back to their own slots, previous ones to
    # a spare column c (no boolean mask: its count would be read back)
    slot = torch.where(st == 1, perm - kp, c)
    out = torch.empty((3, c + 1), dtype=torch.float32, device=dev)
    out[:, slot] = pred
    actf = (active & (keys != 0)).to(torch.float32)
    return out[0, :c] * actf, out[1, :c] * actf, out[2, :c] * actf


def _field_gather(contacts: Contacts, idx: Tensor) -> Contacts:
    """Every field of `contacts` reordered by idx (plain indexing; the
    TPU's packed single-gather encoding is not needed)."""
    return Contacts(*[
        getattr(contacts, f)[:, idx] if f in ("point", "normal")
        else getattr(contacts, f)[idx] for f in Contacts._fields])


def _gather_contacts(contacts: Contacts, lo: Tensor, rb: Tensor,
                     shard: Shard, k: int = 1):
    """The ranks' slices of one contact group (and its endpoint ranks)
    gathered back into the one-process order, through one all-gather of
    their bits as int32 rows. Each rank holds k slot-major blocks ([k·P],
    its P lanes in each block, the pair manifolds' layout); k = 1 is a
    contiguous slice of the group."""
    i32 = torch.int32
    f = {name: getattr(contacts, name) for name in Contacts._fields}
    rows = torch.cat([
        torch.stack([f["body_a"], f["body_b"]]),
        f["point"].view(i32), f["normal"].view(i32),
        torch.stack([f["depth"].view(i32), f["active"].to(i32),
                     f["friction"].view(i32), f["restitution"].view(i32),
                     f["key"], lo, rb])])
    g = all_gather_last(rows, shard)
    g = g.reshape(g.shape[0], shard.size, k, -1).transpose(1, 2).reshape(
        g.shape[0], -1)
    f32 = torch.float32
    full = Contacts(
        body_a=g[0], body_b=g[1], point=g[2:5].view(f32),
        normal=g[5:8].view(f32), depth=g[8].view(f32), active=g[9] != 0,
        friction=g[10].view(f32), restitution=g[11].view(f32), key=g[12])
    return full, g[13], g[14]


def _sharded_capacity(n: int, c_total: int, cfg: SimConfig,
                      shard: Shard) -> int:
    """Contact capacity of the sharded generic solve: the gathered slots
    capped at max_contacts and padded to the tile, then rounded up to
    whole tiles per rank (tile grows with the capacity, up to
    pallas_tile, so this iterates to the fixed point)."""
    c_eff = min(c_total, cfg.max_contacts) if cfg.max_contacts > 0 \
        else c_total
    cp = padded_contact_count(n, c_eff, cfg)
    for _ in range(3):
        tile = solve_shape(n, cp, cfg)[0]
        cp_new = -(-cp // (tile * shard.size)) * (tile * shard.size)
        if cp_new == cp:
            break
        cp = cp_new
    return cp


def banded_inputs(state: SimState, cfg: SimConfig, plain: bool = False):
    """What the generic banded branch's contact list is made from: (sweep
    order | None, each body's sweep rank [N] int32, candidates | None,
    the rank-space geometry table at the solve's width, the contact
    capacity). Without pairs the ranks are the body indices."""
    n = state.num_bodies
    dev = state.device
    pairs = cfg.pair_collisions and n > 1
    order = cand = None
    rank = torch.arange(n, dtype=torch.int32, device=dev)
    if pairs:
        aabbs = body_aabbs(state)
        order = sweep_order(state, aabbs)
        rank = torch.empty_like(rank)
        rank[order.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    cp = contact_capacity(state, cfg)
    geom = unified_geom(state, cfg, order if order is not None else rank,
                        npad=solve_shape(n, cp, cfg)[2])
    if pairs:
        cand = pair_candidates(state, cfg, aabbs=aabbs, order=order,
                               plain=plain)
    return order, rank, cand, geom, cp


def banded_contact_list(state: SimState, cfg: SimConfig,
                        plain: bool = False, shard: Shard | None = None):
    """The contact list of the generic banded branch for boxes: ground
    corners (slot-major [k·N], the TPU route) and banded pair manifolds
    (slot-major [kk·P]), each contact with its endpoint ranks, from one
    launch (ops/narrowphase.banded_contacts). Returns (contacts | None,
    (lo, rank_b), order | None, geom, candidates | None, capacity):
    `geom` is the rank-space geometry table at the solve's width, whose
    narrow-phase block the pair manifolds read and whose solve block the
    solve reads. With `shard` each rank computes its slice of the ground
    slots and of the candidate lanes (the manifolds in chunked mode), and
    each group is all-gathered back into the one-process order."""
    n = state.num_bodies
    order, rank, cand, geom, cp = banded_inputs(state, cfg, plain)
    pairs = cand is not None
    if not (cfg.ground_plane or pairs):
        return None, None, order, geom, cand, cp
    contacts, lo, rb, n_ground = banded_contacts(state, cfg, rank, cand,
                                                 geom, plain=plain,
                                                 shard=shard)
    if shard is None:
        return contacts, (lo, rb), order, geom, cand, cp
    # each group gathered on its own, back into the one-process order (the
    # JAX package gathers each rank's concatenation: the same contacts, in
    # another order among contacts of equal rank)
    groups = []
    if n_ground:
        groups.append(_gather_contacts(_slice_contacts(contacts, 0, n_ground),
                                       lo[:n_ground], rb[:n_ground], shard))
    if pairs:
        kk = (lo.shape[0] - n_ground) // max(
            -(-cand.body_a.shape[0] // shard.size), 1)
        groups.append(_gather_contacts(
            _slice_contacts(contacts, n_ground, lo.shape[0]), lo[n_ground:],
            rb[n_ground:], shard, kk))
    contacts = concat_contacts(*[g[0] for g in groups])
    lo = torch.cat([g[1] for g in groups])
    rb = torch.cat([g[2] for g in groups])
    cp = _sharded_capacity(n, contacts.body_a.shape[0], cfg, shard)
    return contacts, (lo, rb), order, geom, cand, cp


def _slice_contacts(contacts: Contacts, a: int, b: int) -> Contacts:
    """Contacts a..b of the buffer (views)."""
    return Contacts(*[
        getattr(contacts, f)[:, a:b] if f in ("point", "normal")
        else getattr(contacts, f)[a:b] for f in Contacts._fields])


def _resolve_contacts_banded(state: SimState, cfg: SimConfig,
                             plain: bool, shard: Shard | None
                             ) -> Tuple[SimState, Dict]:
    """The generic banded branch for boxes: the contact list, the banded
    solve, the split-impulse pose update, the warm keys sorted with
    their λ."""
    contacts, ranks, order, geom, cand, cp = banded_contact_list(
        state, cfg, plain, shard)
    metrics: Dict = {}
    if cand is not None:
        metrics["pair_overflow"] = cand.overflow
    if contacts is None:
        return state, metrics
    use_warm = tuple(state.contact_key.shape) == (cp,)
    warm = (state.contact_key, state.contact_lam) if use_warm else None
    vel, omega, pvel, pomega, lam3, solve_metrics, contacts = \
        solve_impulses_banded(state, contacts, cfg, order, geom, warm,
                              ranks, cp, plain=plain, shard=shard)
    pos, q = _split_impulse_pose(state, cfg, pvel, pomega)
    state = state.replace(vel=vel, omega=omega, pos=pos, quat=q)
    if use_warm:
        key_s, perm = torch.sort(contacts.key, stable=True)
        state = state.replace(contact_key=key_s,
                              contact_lam=lam3[:, perm].contiguous())
    return state, {**metrics, **solve_metrics}


def _sharded_table(table_fn, st: SimState, cand: PairCandidates | None,
                   cfg: SimConfig, prev, geom: Tensor, plain: bool,
                   shard: Shard):
    """The contact table built by bucket range: rank r builds buckets
    [r·B, (r+1)·B), B = nb / ranks, from its slices of the candidates
    (None: the in-kernel broad phase) and previous keys, and the ranks
    all-gather table, meta and warm rows."""
    n = st.num_bodies
    nb, ccap, _ = table_shape(n, cfg)
    if nb % shard.size:
        raise ValueError(
            f"the sharded contact table needs its {nb} buckets divisible by "
            f"the {shard.size} ranks: pad the scene above "
            f"{BLOCK}·{shard.size} bodies")
    nb_l = nb // shard.size
    b0 = shard.rank * nb_l

    def loc(x, per, dim=0):
        return x.narrow(dim, b0 * per, nb_l * per)

    cand_l = None
    if cand is not None:
        _, cap, _ = bucket_shape(n, cfg)
        cand_l = PairCandidates(loc(cand.body_a, cap), loc(cand.body_b, cap),
                                loc(cand.mask, cap), cand.overflow,
                                loc(cand.rank_a, cap), loc(cand.rank_b, cap))
    prev_l = None
    if prev is not None:
        prev_l = (loc(prev[0], ccap, 1), loc(prev[1], ccap, 1))
    table, meta, warm = table_fn(st, cand_l, cfg, prev=prev_l, geom=geom,
                                 plain=plain, buckets=(b0, nb_l))
    return (all_gather_last(table, shard), all_gather_last(meta, shard),
            all_gather_last(warm, shard) if warm is not None else None)


def _overflow(meta: Tensor, cand: PairCandidates | None) -> Tensor:
    """[pair_overflow, contact_overflow] of a table: candidates the broad
    phase may have missed (the sweep's count, or the table kernel's
    window-edge ranks, meta column 3) plus those dropped beyond the
    lanes (column 2); contacts dropped beyond ccap (column 0)."""
    m = meta[0].reshape(-1, BLOCK)
    win = (cand.overflow if cand is not None
           else torch.sum(m[:, 3]).to(torch.int32))
    return torch.stack([win + torch.sum(m[:, 2]).to(torch.int32),
                        torch.sum(m[:, 0]).to(torch.int32)]).to(torch.int32)


def _rebuild(st: SimState, cfg: SimConfig, use_warm: bool, plain: bool,
             shard: Shard | None = None):
    """Broad phase, geometry table and contact table of one rebuild.
    Returns (table, rank order or None for the packed envs' identity,
    geom, warm rows, overflow counters)."""
    order = cand = None
    if cfg.broadphase != "env_blocks":
        aabbs = body_aabbs(st)
        order = sweep_order(st, aabbs)
        if not cfg.bp_inkernel:
            cand = pair_candidates(st, cfg, aabbs=aabbs, order=order,
                                   plain=plain)
    hulls = hull_table_path(st, cfg)
    geom = unified_geom(st, cfg, order, hulls=hulls)
    prev = (st.contact_key, st.contact_lam) if use_warm else None
    table_fn = bucket_hull_contact_table if hulls else bucket_contact_table
    if shard is not None:
        table, meta, warm = _sharded_table(table_fn, st, cand, cfg, prev,
                                           geom, plain, shard)
    else:
        table, meta, warm = table_fn(st, cand, cfg, prev=prev, geom=geom,
                                     plain=plain)
    return table, order, geom, warm, _overflow(meta, cand)


def refresh_gate(st: SimState, cfg: SimConfig,
                 order: Tensor | None) -> Tensor:
    """The per-bucket displacement gate of a refresh step [NB] bool: each
    body's motion since its bucket's last build (contact_ref), max|Δpos|
    + 2·|Δq|·|half extents| (|Δq| sign-folded, a small-angle bound on the
    drift of its surface), taken per bucket of ranks and folded with the
    next bucket's (forward windows reach into it), against
    vel_factor·slop."""
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
    # a Python float compared with an f32 tensor is rounded to f32, as a
    # tensor of it would be, with no copy to the device (capturable)
    return dmb > cfg.contact_rebuild_vel_factor * cfg.penetration_slop


def _gated_refresh(st: SimState, cfg: SimConfig, order: Tensor | None,
                   geom: Tensor, plain: bool):
    """The table of a gated refresh step: the buckets refresh_gate fires
    recompute their contacts from the current poses through the in-kernel
    broad phase on the persisted order, the others pass their persisted
    block through, and every slot warm-matches (a passed-through bucket
    carries its λ). Returns (table, warm rows, worst-of overflow counters
    — the persisted rebuild's and this step's — and contact_ref reset for
    the bodies of fired buckets)."""
    n = st.num_bodies
    gate = refresh_gate(st, cfg, order)
    table, meta, warm = bucket_contact_table(
        st, None, cfg, prev=(st.contact_key, st.contact_lam), geom=geom,
        plain=plain, gate=(gate, st.contact_table))
    ovf = torch.maximum(st.contact_meta, _overflow(meta, None))
    if order is None:
        fired = gate.repeat_interleave(BLOCK)[:n]
    else:
        rank_of = torch.empty((n,), dtype=torch.int64, device=st.device)
        rank_of[order.long()] = torch.arange(n, device=st.device)
        fired = gate[rank_of // BLOCK]
    ref = torch.where(fired[:, None], torch.cat([st.pos, st.quat], dim=1),
                      st.contact_ref)
    return table, warm, ovf, ref


# The branch an anchored step takes when it is forced (forced_rebuild):
# True rebuild, False refresh, None as _rebuild_now decides.
_FORCED_REBUILD: contextvars.ContextVar = contextvars.ContextVar(
    "forced_rebuild", default=None)

# rebuild_branch's off-schedule step of a hull table path with the motion
# guard: rebuild or refresh as the guard decides on the device
GUARDED = "guarded"


@contextlib.contextmanager
def forced_rebuild(rebuild: bool | None) -> Iterator[None]:
    """Within the block an anchored step rebuilds iff `rebuild` (None: as
    usual). engine.DeviceStepper captures each branch's step under it,
    where the motion guard's read cannot run (its GUARDED graph holds
    both, behind the guard's predicate on the device)."""
    token = _FORCED_REBUILD.set(rebuild)
    try:
        yield
    finally:
        _FORCED_REBUILD.reset(token)


def rebuild_branch(state: SimState, cfg: SimConfig):
    """The branch the next unsharded step of `state` takes, from the
    host's mirror of the step count (nothing read back): None where every
    step is alike (no contacts, or no anchored path); else True on a
    scheduled rebuild (step_count_host % K == 0); off the schedule False
    (refresh), or GUARDED on a hull table path with vel_factor > 0, whose
    motion guard decides rebuild or refresh from the velocities the
    step's contacts see (guard_fires)."""
    if not (cfg.ground_plane or cfg.pair_collisions):
        return None
    if not (cfg.contact_rebuild > 1 and anchored_path(state, cfg)):
        return None
    if state.step_count_host % cfg.contact_rebuild == 0:
        return True
    if hull_table_path(state, cfg) and cfg.contact_rebuild_vel_factor > 0:
        return GUARDED
    return False


def guard_fires(state: SimState, cfg: SimConfig) -> Tensor:
    """The hull table path's global motion guard on `state`'s velocities
    (the step's, after gravity, the joints and the velocity
    integration): the fastest body covers more than vel_factor·slop in K
    steps, max|v|·dt·K > vel_factor·slop in f32. A bool [] on the
    device."""
    dev = state.device
    f32 = torch.float32
    vmax = torch.amax(torch.abs(state.vel))
    return vmax * torch.full((), cfg.dt * cfg.contact_rebuild, dtype=f32,
                             device=dev) > torch.full(
        (), cfg.contact_rebuild_vel_factor * cfg.penetration_slop,
        dtype=f32, device=dev)


def _rebuild_now(state: SimState, cfg: SimConfig, hulls: bool) -> bool:
    """Whether an anchored step (`state` after the velocity integration)
    rebuilds: every contact_rebuild-th step (from the host's mirror of
    step_count), and on a hull table path with vel_factor > 0 also when
    the motion guard fires (guard_fires), read back here: an eager step's
    one read. A step run under forced_rebuild takes the forced branch and
    reads nothing."""
    forced = _FORCED_REBUILD.get()
    if forced is not None:
        return forced
    if state.step_count_host % cfg.contact_rebuild == 0:
        return True
    if not (hulls and cfg.contact_rebuild_vel_factor > 0):
        return False
    return bool(guard_fires(state, cfg))


def _solve_table(state, table, cfg, order, warm, geom, plain, shard=None):
    """solve_impulses_table and the new pose: the solve's integration
    epilogue under fused integration, else the split-impulse update
    (engine.integrate_positions then follows). Returns (vel, omega, lam3,
    metrics, keys, (pos, quat))."""
    vel, omega, pvel, pomega, lam3, metrics, keys, posquat = \
        solve_impulses_table(state, table, cfg, order, warm, geom,
                             fuse=fused_integration(state, cfg, shard),
                             plain=plain, shard=shard)
    if posquat is None:
        posquat = _split_impulse_pose(state, cfg, pvel, pomega)
    return vel, omega, lam3, metrics, keys, posquat


def _resolve_contacts_table(state: SimState, cfg: SimConfig,
                            plain: bool, shard: Shard | None
                            ) -> Tuple[SimState, Dict]:
    n = state.num_bodies
    nb, ccap, cp = table_shape(n, cfg)
    use_warm = tuple(state.contact_key.shape) == (2, cp)

    if cfg.contact_rebuild > 1:
        if (tuple(state.contact_table.shape) != (CT2_ROWS, cp)
                or state.contact_order.shape[0] != n or not use_warm):
            raise ValueError(
                "cfg.contact_rebuild > 1 needs the persisted-table "
                "buffers — call engine.prepare_contacts(state, cfg)")
        # packed envs: the identity order, never sorted; the persisted
        # contact_order stays the prepared arange
        env = cfg.broadphase == "env_blocks"
        hulls = hull_table_path(state, cfg)
        solve_cfg = cfg
        if _rebuild_now(state, cfg, hulls):
            table, order, geom, warm, ovf = _rebuild(state, cfg, True,
                                                     plain)
            ref = torch.cat([state.pos, state.quat], dim=1)
        else:
            order = None if env else state.contact_order
            geom = unified_geom(state, cfg, order, hulls=hulls)
            if not hulls and cfg.contact_rebuild_vel_factor > 0:
                table, warm, ovf, ref = _gated_refresh(state, cfg, order,
                                                       geom, plain)
            else:
                table = state.contact_table
                warm = torch.cat([state.contact_lam, torch.zeros(
                    (5, cp), dtype=torch.float32, device=state.device)])
                ovf = state.contact_meta
                ref = state.contact_ref
            r_it = cfg.contact_refresh_iters
            if 0 < r_it < cfg.contact_iters:
                solve_cfg = cfg.replace(
                    contact_iters=r_it,
                    position_iters=min(cfg.position_iters, r_it))
        vel, omega, lam3, solve_metrics, keys, (pos, q) = _solve_table(
            state, table, solve_cfg, order, warm, geom, plain)
        state = state.replace(
            vel=vel, omega=omega, pos=pos, quat=q,
            contact_key=keys, contact_lam=lam3, contact_table=table,
            contact_order=state.contact_order if env else order,
            contact_meta=ovf, contact_ref=ref)
        return state, {"pair_overflow": ovf[0], "contact_overflow": ovf[1],
                       **solve_metrics}

    # K = 1: rebuild every step
    table, order, geom, warm, ovf = _rebuild(state, cfg, use_warm, plain,
                                             shard)
    vel, omega, lam3, solve_metrics, keys, (pos, q) = _solve_table(
        state, table, cfg, order, warm, geom, plain, shard)
    state = state.replace(vel=vel, omega=omega, pos=pos, quat=q)
    if use_warm:
        state = state.replace(contact_key=keys, contact_lam=lam3)
    return state, {"pair_overflow": ovf[0], "contact_overflow": ovf[1],
                   **solve_metrics}
