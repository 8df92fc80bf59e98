"""The yardstick of the rooflines: the card's peaks, the operations a
unit of work costs, the least-time functions and the names of the port's
kernels. Frozen copies of chip_smoke.py's PEAK_BYTES, PEAK_F32, OPS_*,
PORT_KERNELS and PORT_GROUPS, `bound`, `nbytes`, `sat_lanes`,
`table_bytes`, `mode_bound`, `live_count` and `solve_bound`, and of the
bound in its `check_candidates` (2.1), taking the reference's tensors of
a step (the reference's on_step stats, reference/box_step.py) in place
of the program's."""

from __future__ import annotations

import re

import torch

from portbench.reference.solve import fused_consts_plain
from portbench.reference.table import (
    BLOCK,
    CT_ACT,
    bucket_shape,
    inkernel_candidates,
    lane_geometry,
    obb_prefilter,
    table_operands,
)

# NVIDIA H100 SXM published peaks (data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations per unit of work, counted from the port's CUDA sources
# (each multiply, add, compare, min/max, abs or sqrt is one)
OPS_OBB_PREFILTER = 140      # face-axis OBB test of one candidate lane
OPS_BOX_MANIFOLD = 3500      # 15-axis SAT + 4 clips + edge point, one lane
OPS_GROUND_BODY = 190        # a box's rotation, 8 corners and depths, k picks
OPS_EMIT = 60                # one active contact: anchors, keys, warm key
OPS_SOLVE_CONTACT = 250      # one contact in one Jacobi sweep (3 rows)
OPS_SOLVE_PREP = 400         # one contact's constants in sweep 0
OPS_INTEGRATE = 60           # one body's pos/quat integration
R_RELAX, R_LAM0 = 21, 42     # solve constant rows
OPS_WINDOW_AABB = 30         # a window rank's |R|·half-extent AABB
OPS_RAW_PAIR = 12            # one raw pair's overlap, liveness and env tests

# device-kernel names of the port's csrc/*.cu (2.1's is
# sweep_kernel<true|false>, 2.2's box_table_*, with the warm match
# warm_match_kernel<box_table_warm>, 2.3's solve_kernel<true>)
PORT_KERNELS = ("sweep_kernel", "box_table_", "hull_prefilter_kernel",
                "hull_sat_kernel", "hull_manifold_kernel",
                "hull_ground_kernel", "hull_scan_kernel", "hull_rows_kernel",
                "warm_match_kernel", "solve_kernel", "sharded_sweep_kernel",
                "ground_corners_kernel", "pair_contacts_kernel", "cg_kernel")
PORT_GROUPS = {"2.1 sweep": ("sweep_kernel",),
               "2.2 contact table": ("box_table_",),
               "2.3 solve": ("solve_kernel",)}


def _pattern(parts) -> re.Pattern:
    # a name part not preceded by a letter or _ (sweep_kernel is not
    # sharded_sweep_kernel)
    return re.compile("|".join(rf"(?<![A-Za-z_]){re.escape(p)}"
                               for p in parts))


PORT = _pattern(PORT_KERNELS)
GROUPS = {k: _pattern(v) for k, v in PORT_GROUPS.items()}


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms the card could take, what binds it): the larger of the
    bytes moved once over the memory rate and the f32 operations over the
    peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def sweep_bound(st, cfg, s) -> tuple:
    """2.1's bucketed candidates call: the order, the AABBs and shape
    types read once; every lane's five fields and the overflow written;
    eight compares a (rank, offset)."""
    n = st.num_bodies
    _, cap, nb = bucket_shape(n, cfg)
    k = min(cfg.sweep_window, n - 1)
    lanes = nb * cap
    return bound(4 * n + 24 * n + 4 * n + lanes * (4 * 4 + 1) + 4,
                 8 * n * k)


def sat_lanes(st, geom, cand, cfg):
    """(live candidate lanes, SAT lanes): the survivors of the table's OBB
    prefilter, at most bucket_cap2 a bucket."""
    la, lb, _, kw = table_operands(st, cand, cfg, None, geom, "lanes")
    ga, gb = lane_geometry(geom, la), lane_geometry(geom, lb)
    if kw["cap2"]:
        la, lb, _ = obb_prefilter(ga, gb, la, lb, kw["cap2"])
    return int(cand.mask.sum()), int((la >= 0).sum())


def table_bytes(n, geom, cand, prev, outs) -> int:
    """Bytes a table call must move: the narrow-phase rows of the
    geometry table for the scene's ranks, the candidate lanes, the
    previous keys and impulses; the table, meta and warm rows written."""
    return nbytes(geom[24:48, :n], cand.rank_a, cand.rank_b, *prev, *outs)


def candidates_table_bound(st, cfg, s) -> tuple:
    """2.2 on the bucketed sweep's candidates (the pile's rebuild)."""
    table, meta, warm = s["table_call"]
    live, sat = sat_lanes(st, s["geom"], s["cand"], cfg)
    act = int((table[CT_ACT] > 0).sum())
    return bound(table_bytes(st.num_bodies, s["geom"], s["cand"],
                             s["prev"], (table, meta, warm)),
                 OPS_OBB_PREFILTER * live + OPS_BOX_MANIFOLD * sat
                 + OPS_EMIT * act)


def mode_bound(st, cfg, s) -> tuple:
    """2.2 without candidates (the packed envs), gated or not: the fired
    buckets' window geometry (narrow-phase rows of their ranks and the
    bp_k after), the previous keys and impulses, the persisted blocks of
    the passed-through buckets read; the outputs written. Operations: per
    fired bucket its window AABBs and raw pair tests, the prefilter on
    its stage-1 lanes, the manifold on its SAT lanes, its ground corners;
    the emission of each active contact."""
    n = st.num_bodies
    geom, gate = s["geom"], s["gate"]
    _, _, _, kw = table_operands(st, None, cfg, None, geom, "bound")
    bp_k, cap, env_k = kw["bp"]
    nb, ccap = kw["nb"], kw["ccap"]
    fired = (torch.ones(nb, dtype=torch.bool, device=geom.device)
             if gate is None else gate.bool())
    la, lb, _, _ = inkernel_candidates(geom, nb, 0, bp_k, cap, env_k)
    stage1 = int((la[fired] >= 0).sum())
    sat = stage1
    if kw["cap2"]:
        ga, gb = lane_geometry(geom, la), lane_geometry(geom, lb)
        la2, _, _ = obb_prefilter(ga, gb, la, lb, kw["cap2"])
        sat = int((la2[fired] >= 0).sum())
    cols = torch.zeros(geom.shape[1], dtype=torch.bool, device=geom.device)
    for b in torch.nonzero(fired).flatten().tolist():
        cols[b * BLOCK:b * BLOCK + BLOCK + bp_k] = True
    cols[n:] = False
    f = int(fired.sum())
    table, meta, warm = s["table_call"]
    passed = (table.shape[0] * 4 * ccap * (nb - f)) if gate is not None else 0
    act = int((table[CT_ACT] > 0).sum())
    return bound(24 * 4 * int(cols.sum()) + passed
                 + nbytes(*s["prev"], table, meta, warm),
                 f * (OPS_WINDOW_AABB * (BLOCK + bp_k) + OPS_RAW_PAIR
                      * BLOCK * bp_k + OPS_GROUND_BODY * BLOCK)
                 + (OPS_OBB_PREFILTER * stage1 if kw["cap2"] else 0)
                 + OPS_BOX_MANIFOLD * sat + OPS_EMIT * act)


def live_count(consts, warm: bool) -> int:
    """How many contacts the later sweeps of 2.3 visit: those with a
    relaxation or, after sweep 0's warm start, an impulse."""
    live = consts[R_RELAX] != 0
    if warm:
        for k in range(3):
            live = live | (consts[R_LAM0 + k] != 0)
    return int(live.sum())


def solve_bound(st, cfg, s) -> tuple:
    """2.3's least time: the activity row of every slot; the table rows
    (the anchors too on anchored paths) and the 3 warm rows of the active
    slots; the 24 solve rows of the geometry of the n bodies; z, λ and
    pos/quat out. Sweep 0 does the constants and one sweep's work for
    every active contact, each later sweep for the live ones, then n
    integrations."""
    table, geom, warm = s["table"], s["geom"], s["warm"]
    n = st.num_bodies
    cp = table.shape[1]
    anchored = cfg.contact_rebuild > 1
    cs = fused_consts_plain(
        table, warm, geom, use_split=True, anchored=anchored,
        baum_over_dt=cfg.baumgarte / cfg.dt, slop=cfg.penetration_slop,
        relaxation=cfg.contact_relaxation)[0]
    live = live_count(cs, True)
    act = int((table[CT_ACT] > 0).sum())
    trows = 25 if anchored else 16
    npad = geom.shape[1]
    out = 4 * (16 * npad + 4 * cp + 8 * npad)      # z, λ, pos/quat
    ops = act * (OPS_SOLVE_PREP + OPS_SOLVE_CONTACT) \
        + live * OPS_SOLVE_CONTACT * (s["sweeps"] - 1) + n * OPS_INTEGRATE
    return bound(4 * cp + 4 * (trows + 3) * act + 4 * 24 * n + out, ops)
