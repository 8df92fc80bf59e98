"""GPU smoke run of physics_tpu_torch on one NVIDIA card: the 4,096-body
box pile (on the contact-table path and on the two-kernel path), the
1,024-hull rain and 4,096 packed environments of 8 boxes stepping through
the port's hand-written kernels, on one process and row-sharded over 4
ranks; the reference engine's jointed demo scene and 4,096 packed
jointed pendulums through the joint CG kernel.

    python3 chip_smoke.py            # needs CUDA; exits non-zero without
    python3 chip_smoke.py --solve-levers   # + the solves' design levers

Phases (any failure raises, so the run exits non-zero):
  1. card     name and power limit (nvidia-smi);
  2. build    compile csrc/*.cu with nvcc, one process per source, all at
              once, and print ptxas's per-kernel report and the
              persistent solve's grid at the table paths' widths;
  3. kernels  each pile kernel against its plain PyTorch version, on the
              card, at the pile's shapes (a pile settled by 60 steps),
              with median times from CUDA events and the live contacts of
              the solve: 2.1 in its masks mode and in its candidates
              mode (pair_candidates, every field identical);
  4. pile     prepare_contacts + 240 steps of pile_config(4096) with
              contact_iters=8 through step_with_metrics: launch counts,
              finite state, overflow counters, one rebuild and one refresh
              step of the kernel path against the plain path, and the
              step rate over a timed window;
  5. rain     mesh_rain(1024) under rain_config(1024), settled 60 steps:
              2.1's candidates, the hull contact table and the solve
              against their plain versions at the rain's shapes, then 240
              fresh steps with the
              same checks and measurements as phase 4;
  6. mixed    mesh_rain_mixed(128, n_types=3) settled 60 steps: the hull
              table against its plain version with all 9 ordered hull-type
              pairs live;
  7. two-kernel pile
              the 4k pile under pile_config(4096).replace(contact_iters=8,
              contact_table=False), settled 60 steps: 2.1's candidates,
              the contact list (ground corners and pair manifolds in one
              launch), the unfused sweeps (2.5) against their plain
              version and the solve constants their sweep 0 builds (2.6,
              folded in) against prep_consts_plain, bit for bit, at the
              path's shapes, then 240 fresh steps
              with the checks and measurements of phase 4 (one cold step,
              with no warm buffers, and one warm step, with live keys,
              against the plain path); and one warm step of
              the unfused table solve (fuse_prep=False), with and without
              fuse_integrate, against the plain path;
  8. packed   scenes.packed_envs(4096, 8) under packed_env_config (the
              env_blocks table, identity order, K = 32 with the per-bucket
              displacement gate), settled 60 steps: the contact table
              against its plain version in its three candidate-free
              modes at the path's shapes (the packed rebuild; a refresh
              with every bucket fired, with 1 bucket in 16 fired, with
              none fired), each timed by CUDA events and by its kernel's
              device time, and the solve (2.3) on the rebuild's table
              and the persisted one; then 240 fresh steps with the checks
              and measurements of phase 4 and overflow counters 0 at the
              end;
  9. gated    the settled 4k pile under contact_rebuild_vel_factor 2: a
              gated refresh table (its own gate, then a mixed one) and a
              refresh step against the plain path; then at
              contact_rebuild 1 with bp_inkernel: the table of the
              in-kernel broad phase on the sweep order (window-edge
              counts in meta column 3) and a step against the plain path;
 10. faces    the hull table against its plain version on rains of
              octahedra (faces of 3 vertices), hexagonal prisms (6),
              12-gon, 20-gon and 63-gon prisms (12, 20, 63: the last two
              above what the manifold holds in registers), and the
              octahedra under
              rain_config's motion guard (vel_factor 2): guard rebuilds
              counted over 12 steps, a guard step against the plain path;
 11. sharded  the single-sweep kernel (2.7) against its plain version on
              one rank's quarter of each sharded path's solve (the 4k
              table pile's timed), in each of its four switch
              combinations (sweep 0 on a fresh scratch, its constants
              bit for bit prep_consts_plain's, a later sweep on the
              plain loop's scratch: live list and next snapshot table
              identical); the contact-list kernel (2.8) on each rank's
              quarter of the two-kernel pile's ground slots and candidate
              lanes (chunked mode); the box and hull table kernels by
              bucket range against the full-range kernels' blocks; then 4
              ranks (gloo, all on this card; NCCL with a card each when
              there are 4) step the 4k table pile, the 1,024-hull rain and the
              two-kernel pile through row_sharded_step, from the states
              phases 4, 5 and 7 ended with: launch counts summed over the
              ranks, finite state; then one more sharded step, through
              step_with_metrics with the rank's shard: overflow counters,
              every rank's state bitwise equal to rank 0's, and the step
              against the one-process kernel path from the same state;
 12. rollout  engine.rollout on the card, a captured CUDA graph a branch of
              the step (DeviceStepper), on the table pile, the rain, the
              two-kernel pile and the packed envs: from the state each
              path's drive ended with, 2K + 2 steps (3 off the anchored
              paths), each replayed step against an eager step from a copy
              of the same state (integer fields identical, f32 within
              1e-4); then from fresh scenes, in this process, 240 eager
              steps and 240 steps of a DeviceStepper, ms/step over steps
              40..240 on the host clock ending in a synchronize, and one
              rollout(240, sample_every=40) call with the launch counters
              set to 0 just before and read just after (its warm-up steps
              launch, each replay adds what its graph captured);
 13. profile  device time by kernel over 8 more steps of each path
              (torch.profiler), after every timed window, eager and
              replayed (the device's busy share of each); then the device
              µs a launch of each mode of 2.2 (the pile's candidates, the
              packed, gated and sweep modes; split by __global__) and of
              each solve checked in phases 3, 5, 7, 8 and 11 (2.3, 2.5,
              2.7's sweep 0 and a later sweep), beside its CUDA-event
              time, its bound and its live contacts; the device
              operations and µs of 2.1's pair_candidates call at the
              pile's, rain's and two-kernel pile's shapes and of a 2.7
              sweep; with
              --solve-levers, each 2.3 and 2.5 call's device µs under
              each variant of LEVERS (banded_solve.cu rebuilt from a
              patched copy), in turns: design, the variants, design;
              the joint CG's device µs a launch at both sizes of phase
              14, and the jointed envs' profiles, eager and replayed;
 14. joints   (run before phase 13's profiles) demo_scene() under
              compat_config(dt=1/60): the joint CG kernel against its
              plain version on its first step, then 300 eager steps
              against the port's copy of the NumPy oracle (largest
              position error < 1e-3, final quaternion error < 1e-2) and
              replayed steps against eager ones; 4,096 packed pendulums
              (tests/test_pack_envs.py's two-body env, 8,192 bodies,
              8,192 joint slots, 24,576 CG rows) under SimConfig(dt=
              1/120): the CG kernel against its plain version after the
              settling steps (iterations and stop equal, λ within
              CG_RTOL), 240 fresh eager steps (one CG launch each, CG
              iterations a step and the stop, finite state), replayed
              steps against eager ones and phase 12's timing and
              rollout for this path; phase 10's octahedra under the
              motion guard through the device stepper: GUARDED replays
              against eager steps; then 6 steps of 24 octahedra (vel_factor
              8) whose replays run under
              torch.cuda.set_sync_debug_mode("error") (no host read),
              with the eager drive's launch counts (the guard's rebuilds)
              and final poses (GUARD_POSE_ATOL).
The line before the last is a JSON object of per-kernel results (each
kernel's least possible time on the card, `bound_ms`, is computed from
this run's inputs); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from physics_tpu_torch import _build, scenes
from physics_tpu_torch.config import SimConfig, compat_config
from physics_tpu_torch.engine import (
    DeviceStepper,
    joint_system,
    prepare_contacts,
    rollout,
    step_with_metrics,
)
from physics_tpu_torch.envs import offset_envs, pack_envs
from physics_tpu_torch.io.meshes import box_inertia
from physics_tpu_torch.io.primitives import octahedron_verts, prism_verts
from physics_tpu_torch.ops.forces import apply_gravity
from physics_tpu_torch.oracle import reference as oracle
from physics_tpu_torch.scene import SceneBuilder, demo_scene
from physics_tpu_torch.solver import cg
from physics_tpu_torch.ops import hull_table as ht
from physics_tpu_torch.ops.broadphase import (
    PairCandidates,
    body_aabbs,
    bucket_shape,
    pair_candidates,
    sweep_order,
)
from physics_tpu_torch.ops.contact_table import (
    BLOCK,
    table_shape,
    CT_ACT,
    CT_KH,
    CT_KL,
    CT_KS,
    CT_KSGN,
    CT_MU,
    CT_RA,
    CT_RB1,
    CT_REST,
    bucket_contact_table,
    inkernel_candidates,
    lane_geometry,
    obb_prefilter,
    table_operands,
    unified_geom,
)
from physics_tpu_torch.ops.narrowphase import banded_contacts
from physics_tpu_torch.ops.narrowphase_banded import pair_operands
from physics_tpu_torch.ops.sweep_kernel import (
    bucketed_candidates,
    sweep_window_masks,
)
from physics_tpu_torch.parallel.collectives import Shard, all_reduce_sum
from physics_tpu_torch.parallel.sharding import launch, row_sharded_step
from physics_tpu_torch.solver.banded_solve import (
    CIN_ROWS,
    R_PREP,
    R_SWEEP,
    banded_operands,
    banded_sweep_once,
    banded_sweeps,
    banded_sweeps_fused,
    banded_z0,
    folded_prep_consts,
    fused_consts_plain,
    prep_consts_plain,
    prep_kw,
    rows_of,
    solve_plan,
    sweep_scratch,
    table_solve_operands,
)
from physics_tpu_torch.solver.contacts import (
    GUARDED,
    _rebuild,
    _rebuild_now,
    _sharded_capacity,
    anchored_path,
    banded_contact_list,
    banded_inputs,
    rebuild_branch,
    refresh_gate,
)
from physics_tpu_torch.state import SHAPE_NONE, state_from_arrays, to_numpy

EXACT_ROWS = [CT_ACT, CT_KL, CT_KH, CT_KSGN, CT_RA, CT_RB1, CT_KS, CT_MU,
              CT_REST]
# kernel vs plain on the card. The contact tables and the contact list
# compute the same f32 operations in the same order (nvcc -fmad=false), so
# they should agree to the bit; 1e-5 of the scene extent is allowed. The
# solve constants (2.6, built in the sweep 0 of 2.5 and 2.7) have no sums
# across contacts: bit for bit on the touched slots. The solves sum impulse
# deltas with atomics in a run-dependent order: 1e-4 of each output row's
# largest magnitude, and 1e-4 absolute for one whole step's state.
# The joint CG (csrc/joint_cg.cu) sums its dot products in the plain
# version's fixed order and each pendulum body takes at most two joints'
# atomic adds (one sum in either order): iterations and stop equal, λ
# within CG_RTOL of its largest magnitude. A guarded rain's horizon
# amplifies the solves' run-to-run atomic differences (8 steps of phase
# 10's squeezed octahedra: replayed and eager ends 1.4e-3 to 3.0e-2 apart,
# though each replayed step is within 3.6e-7 of its eager step): the
# horizon runs on a milder rain (24 octahedra, 6 steps: ends within 1e-3
# in the GPU tests), its decisions compared exactly (the launch counts),
# its final poses to GUARD_POSE_ATOL, each single step to STEP_ATOL.
TABLE_TOL = 1e-5
SOLVE_RTOL = 1e-4
STEP_ATOL = 1e-4
CG_RTOL = 1e-5
GUARD_POSE_ATOL = 5e-2
N_PEND = 4096
N_PILE = 4096
N_RAIN = 1024
N_ENVS, ENV_K = 4096, 8
RANKS = 4
STEP_COUNTERS = ("contact_count", "pair_overflow", "contact_overflow",
                 "band_overflow")

# NVIDIA H100 SXM published peaks (data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations per unit of work, counted from the CUDA sources (each
# multiply, add, compare, min/max, abs or sqrt is one)
OPS_OBB_PREFILTER = 140      # face-axis OBB test of one candidate lane
OPS_BOX_MANIFOLD = 3500      # 15-axis SAT + 4 clips + edge point, one lane
OPS_GROUND_BODY = 190        # a box's rotation, 8 corners and depths, k picks
OPS_EMIT = 60                # one active contact: anchors, keys, warm key
OPS_SOLVE_CONTACT = 250      # one contact in one Jacobi sweep (3 rows)
OPS_SOLVE_PREP = 400         # one contact's constants in sweep 0
OPS_INTEGRATE = 60           # one body's pos/quat integration
R_RELAX, R_LAM0 = 21, 42     # solve constant rows (csrc/banded_solve.cu R_*)
OPS_WINDOW_AABB = 30         # a window rank's |R|·half-extent AABB
OPS_RAW_PAIR = 12            # one raw pair's overlap, liveness and env tests
OPS_CG_SLOT = 200            # one two-body joint slot in one CG iteration
# device-kernel names of csrc/*.cu (2.1's is sweep_kernel<true|false>,
# 2.2's box_table_*, 2.4's hull_*; their shared warm match is
# warm_match_kernel<box_table_warm> or <hull_table_warm>)
PORT_KERNELS = ("sweep_kernel", "box_table_", "hull_prefilter_kernel",
                "hull_sat_kernel", "hull_manifold_kernel", "hull_ground_kernel",
                "hull_scan_kernel", "hull_rows_kernel", "warm_match_kernel",
                "solve_kernel", "sharded_sweep_kernel",
                "ground_corners_kernel", "pair_contacts_kernel", "cg_kernel")
BOX_TABLE = ("box_table_",)
KERNEL_NAME = r"\w+_kernel"      # a kernel's name in a profiler key
PORT_GROUPS = {"2.2 contact table": BOX_TABLE,
               "2.4 hull table": ("hull_",),
               "2.8 banded contacts": ("ground_corners_kernel",
                                       "pair_contacts_kernel")}
# 2.1's pair_candidates call at each path's shapes, profiled in phase 12
CANDIDATE_CALLS = {}
# a solve checked in phases 3-11, measured by device time in phase 12:
# its kernel, label, wrapper call, CUDA-event ms, bound and live contacts
Solve = collections.namedtuple("Solve", "name label call ms bound live")


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    line = smi.splitlines()[torch.cuda.current_device()]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return line


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what binds it): the larger of the
    bytes moved once over the memory rate and the f32 operations over the
    peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def row_check(name, got, ref, rtol):
    """max |got − ref| over rows, each within rtol · max(|ref row|, 1e-3)."""
    err = 0.0
    for r in range(ref.shape[0]):
        d = float((got[r] - ref[r]).abs().max())
        tol = rtol * max(float(ref[r].abs().max()), 1e-3)
        if not d <= tol:
            raise AssertionError(f"{name} row {r}: |Δ| {d} > {tol}")
        err = max(err, d)
    return err


def sat_lanes(state, geom, cand, cfg, hulls: bool):
    """(live candidate lanes, the lanes the SAT runs on as two [24, L]
    lane geometries): the survivors of the tables' OBB prefilter, at most
    bucket_cap2 per bucket; for hulls, only the lanes the SAT does not
    skip (two hulls, one of them movable)."""
    la, lb, _, kw = table_operands(state, cand, cfg, None, geom, "lanes")
    ga, gb = lane_geometry(geom, la), lane_geometry(geom, lb)
    if kw["cap2"]:
        la, lb, _ = obb_prefilter(ga, gb, la, lb, kw["cap2"], hulls)
        ga, gb = lane_geometry(geom, la), lane_geometry(geom, lb)
    keep = la >= 0
    if hulls:
        keep = keep & ((ga[17] > 0) | (gb[17] > 0)) & (ga[19] > 0) & (
            gb[19] > 0)
    return int(cand.mask.sum()), ga[:, keep], gb[:, keep]


def live_count(consts, warm: bool) -> int:
    """How many contacts of solve constants `consts` (R_* rows) the later
    sweeps of 2.3 and 2.5 visit: those with a relaxation or, after sweep
    0's warm start, an impulse (csrc/banded_solve.cu solve_kernel)."""
    live = consts[R_RELAX] != 0
    if warm:
        for k in range(3):
            live = live | (consts[R_LAM0 + k] != 0)
    return int(live.sum())


def solve_bound(table, geom, z, lam, pq, *, sweeps: int, n: int, act: int,
                live: int, anchored: bool):
    """2.3's least time: the activity row of every slot; the table rows
    (point, normal, depth, friction, restitution, ranks; the anchors too
    on anchored paths) and the 3 warm rows of the `act` active slots; the
    24 solve rows of the geometry of the n bodies; z, λ and pos/quat out.
    Sweep 0 does the constants and one sweep's work for every active
    contact, each later sweep for the `live` ones, then n integrations."""
    cp = table.shape[1]
    trows = 25 if anchored else 16
    ops = act * (OPS_SOLVE_PREP + OPS_SOLVE_CONTACT) \
        + live * OPS_SOLVE_CONTACT * (sweeps - 1) + n * OPS_INTEGRATE
    return bound(4 * cp + 4 * (trows + 3) * act + 4 * 24 * n
                 + nbytes(z, lam, pq), ops)


def check_solve(state, cfg, table, warm, geom, label):
    """2.3 on a fresh table (rebuild schedule) and on the state's
    persisted table (refresh schedule). Returns (max err, {schedule:
    (kernel ms, plain ms, bound)}, [Solve])."""
    n = state.num_bodies
    cp = table.shape[1]
    geom_r = unified_geom(state, cfg, state.contact_order,
                          hulls=cfg.hull_table)
    warm_r = torch.cat([state.contact_lam, torch.zeros(
        (5, cp), device=geom.device)])
    cases = {"rebuild": (table, warm, geom, cfg.contact_iters),
             "refresh": (state.contact_table, warm_r, geom_r,
                         cfg.contact_refresh_iters)}
    err_s = 0.0
    out = {}
    solves = []
    anchored = cfg.contact_rebuild > 1
    for sched, (tab, wrm, g, it) in cases.items():
        def run(plain, tab=tab, wrm=wrm, g=g, it=it):
            return banded_sweeps_fused(
                tab, wrm, g, cfg, vel_iters=it, pos_iters=it,
                use_split=True, integrate=(cfg.dt, True), plain=plain)
        zk, lk4, pk = run(False)
        zp, lp4, pp = run(True)
        e = max(row_check(f"solve {sched} z", zk[:, :n], zp[:, :n],
                          SOLVE_RTOL),
                row_check(f"solve {sched} lam", lk4, lp4, SOLVE_RTOL),
                row_check(f"solve {sched} posq", pk[:, :n], pp[:, :n],
                          SOLVE_RTOL))
        err_s = max(err_s, e)
        kms, pms = median_ms(lambda: run(False), 20), median_ms(
            lambda: run(True), 3)
        cs = fused_consts_plain(
            tab, wrm, g, use_split=True, anchored=anchored,
            baum_over_dt=cfg.baumgarte / cfg.dt, slop=cfg.penetration_slop,
            relaxation=cfg.contact_relaxation)[0]
        live = live_count(cs, True)
        act = int((tab[CT_ACT] > 0).sum())
        bnd = solve_bound(tab, g, zk, lk4, pk, sweeps=it + 1, n=n, act=act,
                          live=live, anchored=anchored)
        out[sched] = (kms, pms, bnd)
        solves.append(Solve("banded_sweeps_fused", f"{label} {sched}",
                            lambda run=run: run(False), kms, bnd, live))
        log(f"2.3 banded solve ({label} {sched}, {it + 1} sweeps): "
            f"max |Δ| {e}; kernel {kms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bnd[0]:.5f} ms ({bnd[1]}); {live} live of {act} "
            f"active of {tab.shape[1]} slots")
    return err_s, out, solves


def check_table(name, fn_kernel, fn_plain, n, geom):
    """A contact-table kernel against its plain version: integer rows,
    meta and warm rows identical, f32 rows within TABLE_TOL × extent.
    Returns (outputs, max err, kernel ms, plain ms, active contacts)."""
    tk, mk, wk = fn_kernel()
    tp, mp, wp = fn_plain()
    for r in EXACT_ROWS:
        if not torch.equal(tk[r], tp[r]):
            raise AssertionError(f"{name}: table row {r} differs")
    if not (torch.equal(mk, mp) and torch.equal(wk, wp)):
        raise AssertionError(f"{name}: meta/warm rows differ")
    extent = float(geom[0:3, :n].abs().max())
    err = float((tk - tp).abs().max())
    if not err <= TABLE_TOL * extent:
        raise AssertionError(f"{name}: f32 rows |Δ| {err}")
    kms = median_ms(fn_kernel, 20)
    pms = median_ms(fn_plain, 3)
    return (tk, mk, wk), err, kms, pms, int(tk[CT_ACT].sum())


def table_bytes(state, geom, cand, prev, outs, *extra) -> int:
    """Bytes a table call must move: the narrow-phase rows of the
    geometry table (24:48, the only rows either table reads) for the
    scene's ranks, the candidate lanes, the previous keys and impulses,
    and `extra` (the hull library); the table, meta and warm rows
    written."""
    return nbytes(geom[24:48, :state.num_bodies], cand.rank_a, cand.rank_b,
                  *prev, *outs, *extra)


def device_ops(fn, reps: int = 5):
    """(device operations a call of fn puts on the card, their device µs
    a call, {kernel, copy or memset: count a call}) over `reps` calls
    (torch.profiler; run after every timed window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count / reps, e.self_device_time_total / reps)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return (sum(r[1] for r in rows), sum(r[2] for r in rows),
            {r[0][:60]: r[1] for r in rows})


def check_candidates(label, state, cfg):
    """2.1, the bucketed candidates from the sort order in one launch,
    against its plain version: every field and the overflow identical.
    Returns (0.0, kernel ms, plain ms, bound) and keeps the call for the
    device profile of phase 12."""
    n = state.num_bodies
    aabbs = body_aabbs(state)
    order = sweep_order(state, aabbs)

    def run(plain):
        return pair_candidates(state, cfg, aabbs, order, plain=plain)
    ck, cp = run(False), run(True)
    for f, a, b in zip(ck._fields, ck, cp):
        if not (a.dtype == b.dtype and torch.equal(a, b)):
            raise AssertionError(f"2.1 candidates ({label}): {f} differs")
    block, cap, nb = bucket_shape(n, cfg)
    k = min(cfg.sweep_window, n - 1)
    # the order, the AABBs and shape types read once; every lane's five
    # fields and the overflow written; eight compares a (rank, offset)
    bnd = bound(nbytes(order, aabbs, state.shapes.stype, *ck), 8 * n * k)
    kms = median_ms(lambda: run(False), 50)
    pms = median_ms(lambda: run(True), 5)
    CANDIDATE_CALLS[label] = lambda: run(False)
    log(f"2.1 bucketed candidates ({label}): every field identical "
        f"({int(ck.mask.sum())} live of {ck.mask.numel()} lanes, {nb} "
        f"buckets of {block} ranks, window {k}, cap {cap}, overflow "
        f"{int(ck.overflow)}); kernel {kms:.4f} ms, plain {pms:.4f} ms, "
        f"bound {bnd[0]:.5f} ms ({bnd[1]})")
    return 0.0, kms, pms, bnd


def check_pile_kernels(state, cfg):
    """Phase 3: each pile kernel against its plain version at the pile's
    shapes. Returns ({name: (max_abs_err, ms, plain_ms, bound)},
    [Solve], 2.2's candidates mode as check_table_modes gives a mode)."""
    n = state.num_bodies
    out = {}
    aabbs = body_aabbs(state)
    order = sweep_order(state, aabbs)
    oi = order.long()
    aabb_s = aabbs[oi].contiguous()
    coll_s = (state.shapes.stype != SHAPE_NONE)[oi].contiguous()
    k = min(cfg.sweep_window, n - 1)
    mk, lk = sweep_window_masks(aabb_s, coll_s, k)
    mp, lp = sweep_window_masks(aabb_s, coll_s, k, plain=True)
    if not (torch.equal(mk, mp) and torch.equal(lk, lp)):
        raise AssertionError("sweep masks differ from the plain version")
    log(f"2.1 sweep masks mode: identical ({int(mk.sum())} overlaps, "
        f"{int(lk.sum())} window-edge ranks)")
    out["sweep_window_masks"] = check_candidates("pile", state, cfg)

    cand = pair_candidates(state, cfg, aabbs, order)
    geom = unified_geom(state, cfg, order)
    prev = (state.contact_key, state.contact_lam)
    (tk, mk, wk), err, kms, pms, act = check_table(
        "contact table",
        lambda: bucket_contact_table(state, cand, cfg, prev=prev, geom=geom),
        lambda: bucket_contact_table(state, cand, cfg, prev=prev, geom=geom,
                                     plain=True),
        n, geom)
    meta = mk[0].reshape(-1, BLOCK)
    live, ga, _ = sat_lanes(state, geom, cand, cfg, hulls=False)
    sat = ga.shape[1]
    bnd = bound(table_bytes(state, geom, cand, prev, (tk, mk, wk)),
                OPS_OBB_PREFILTER * live + OPS_BOX_MANIFOLD * sat
                + OPS_EMIT * act)
    log(f"2.2 contact table: keys/activity/ranks/meta/warm identical, f32 "
        f"rows max |Δ| {err}; {act} contacts, dropped "
        f"{int(meta[:, 0].sum())}, prefilter drops {int(meta[:, 2].sum())};"
        f" kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.5f} ms "
        f"({bnd[1]}; {live} candidate lanes, {sat} SAT lanes)")
    out["bucket_contact_table"] = (err, kms, pms, bnd)
    # 2.2's candidates mode, as phase 12 times each mode
    mode = (err, kms, pms, bnd, int(meta.shape[0]),
            lambda: bucket_contact_table(state, cand, cfg, prev=prev,
                                         geom=geom))
    err_s, times, solves = check_solve(state, cfg, tk, wk, geom, "pile")
    out["banded_sweeps_fused"] = (err_s,) + times["rebuild"]
    return out, solves, mode


def hull_table_ops(geom, cand, cfg, state, act):
    """The f32 operations a hull table needs on these inputs: the least
    work of the function, not of the linear-coefficient form the kernel
    evaluates. Each SAT lane of ordered type pair (a, b), with F faces,
    V vertices, D edge directions and E2 edges of each hull from the
    library: each hull's vertices into the other's frame (18 per
    vertex); every face against the other hull's vertices, a 3-term dot
    and a min each (6); D_a·D_b edge axes, each a cross product, its
    length, both hulls' supports (7 per vertex) and the separation (31);
    then, counted from csrc/hull_table.cu, the incident face (6 per face
    of the smaller hull), the two face polygons into world, the clip
    frame, E clips of 2E slots (19 per slot), the edge-edge point (3 per
    edge and the chosen axis' supports) and kk top-k picks. The
    prefilter per live candidate lane; per hull rank the kg lowest of
    its vertices (6 to place one, kg compares); per active contact its
    emission. Returns (operations, live lanes, SAT lanes, the SAT lanes'
    ordered type pairs)."""
    hs = state.hulls
    dm = ht.hull_dims(hs)
    e = dm.e
    live, ga, gb = sat_lanes(state, geom, cand, cfg, hulls=True)
    ta, tb = (ga[19] - 1).long(), (gb[19] - 1).long()
    f, v = hs.face_count.double(), hs.vert_count.double()
    d, e2 = hs.edge_dir_count.double(), hs.edge_count.double()
    fa, fb, va, vb = f[ta], f[tb], v[ta], v[tb]
    sat = (75 + 18 * (va + vb) + 6 * (fa * vb + fb * va) + 2 * (fa + fb)
           + 15 * d[tb] + d[ta] * d[tb] * (31 + 7 * (va + vb)))
    manifold = (6 * torch.minimum(fa, fb) + 36 * e + 21 + 30 + 26 * e
                + e * 2 * e * 19 + 3 * (e2[ta] + e2[tb]) + 7 * (va + vb)
                + 132 + 56 * min(cfg.max_contacts_per_pair, 2 * e + 1))
    kg = min(cfg.max_contacts_per_pair, 8, dm.vcap)
    vr = v[torch.clamp(state.shapes.hull_index, 0).long()]
    ops = (OPS_OBB_PREFILTER * live + float((sat + manifold).sum())
           + float(((6 + kg) * vr).sum()) + OPS_EMIT * act)
    return ops, live, ta.numel(), ta * hs.verts.shape[0] + tb


def check_hull_table(state, cfg, label):
    """2.4 against its plain version at this scene's shapes. Returns
    (outputs, geom, the ordered type pair of each lane the SAT runs on,
    max err, kernel ms, plain ms, bound)."""
    n = state.num_bodies
    aabbs = body_aabbs(state)
    order = sweep_order(state, aabbs)
    cand = pair_candidates(state, cfg, aabbs, order)
    geom = unified_geom(state, cfg, order, hulls=True)
    prev = (state.contact_key, state.contact_lam)
    (tk, mk, wk), err, kms, pms, act = check_table(
        "hull table",
        lambda: ht.bucket_hull_contact_table(state, cand, cfg, prev=prev,
                                             geom=geom),
        lambda: ht.bucket_hull_contact_table(state, cand, cfg, prev=prev,
                                             geom=geom, plain=True),
        n, geom)
    meta = mk[0].reshape(-1, BLOCK)
    ops, live, sat, pairs_sat = hull_table_ops(geom, cand, cfg, state, act)
    library = [getattr(state.hulls, f.name)
               for f in dataclasses.fields(state.hulls)]
    bnd = bound(table_bytes(state, geom, cand, prev, (tk, mk, wk),
                            *library), ops)
    pairs = int((tk[CT_ACT] * (1 - tk[CT_KSGN])).sum())
    log(f"2.4 hull table ({label}): keys/activity/ranks/meta/warm "
        f"identical, f32 rows max |Δ| {err}; {act} contacts ({pairs} "
        f"pair), dropped {int(meta[:, 0].sum())}, prefilter drops "
        f"{int(meta[:, 2].sum())}; kernel {kms:.4f} ms, plain {pms:.4f} ms,"
        f" bound {bnd[0]:.5f} ms ({bnd[1]}; {live} candidate lanes, {sat} "
        f"SAT lanes)")
    return (tk, mk, wk), geom, pairs_sat, err, kms, pms, bnd


def state_close(a, b, what):
    for name in ("pos", "quat", "vel", "omega"):
        d = float((getattr(a, name) - getattr(b, name)).abs().max())
        if not d <= STEP_ATOL:
            raise AssertionError(f"{what}: {name} |Δ| {d} > {STEP_ATOL}")
    if not torch.equal(a.contact_key, b.contact_key):
        raise AssertionError(f"{what}: contact keys differ")


class EagerStepper:
    """Eager steps of a state, with DeviceStepper's `step`."""

    def __init__(self, state, cfg):
        self.state, self.cfg = state, cfg

    def step(self):
        self.state, _ = step_with_metrics(self.state, self.cfg)
        return self.state


def profile_steps(stepper, steps: int) -> None:
    """Device time by kernel over `steps` steps of `stepper` (eager or
    replayed; torch.profiler), and the device's busy share: of the
    profiled wall time (which the profiler's own overhead lengthens, so
    the share is a lower bound), and of the wall time of 3·steps steps
    just before, unprofiled (host clock, ending in a synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3 * steps):
        stepper.step()
    torch.cuda.synchronize()
    plain_us = 1e6 * (time.perf_counter() - t0) / (3 * steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            stepper.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): the host operators that
    # launched them report the same device time again
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"profile over {steps} steps: no device events recorded "
            f"(device busy not measured), {wall_us / steps:.1f} us/step wall")
        return
    log(f"profile over {steps} steps: device busy {busy / steps:.1f} us/step"
        f" of {wall_us / steps:.1f} us/step wall ({100 * busy / wall_us:.1f}%"
        f" busy), {sum(r[1] for r in rows) / steps:.0f} device ops/step; "
        f"{plain_us:.1f} us/step unprofiled just before "
        f"({100 * busy / steps / plain_us:.1f}% busy)")
    for us, count, key in rows[:15]:
        log(f"  {us / steps:9.1f} us/step  {count / steps:6.1f}/step  "
            f"{key[:90]}")
    # the port's own kernels, wherever they rank: their device time alone,
    # without the wrappers' glue that the CUDA-event times include
    for us, count, key in rows:
        if any(k in key for k in PORT_KERNELS):
            log(f"  port {us / count:8.1f} us/launch {count / steps:6.2f}/step"
                f"  {key[:70]}")
    # a wrapper launch of the redesigned kernels: all of its __global__s
    for name, parts in PORT_GROUPS.items():
        got = [(us, count) for us, count, key in rows
               if any(p in key for p in parts)]
        if got:
            calls = max(c for _, c in got)
            log(f"  port {sum(u for u, _ in got) / calls:8.1f} us/launch "
                f"{calls / steps:6.2f}/step  {name}: all {len(got)} kernels")


# kernel (named after the TPU function it replaces) → its wrapper, whose
# `launches` counts the kernel's launches
COUNTED = {"sweep_window_masks": bucketed_candidates,
           "bucket_contact_table": bucket_contact_table,
           "bucket_hull_contact_table": ht.bucket_hull_contact_table,
           "banded_sweeps_fused": banded_sweeps_fused,
           "pair_manifolds_banded": banded_contacts,
           # 2.6 runs in the sweep 0 of 2.5 and 2.7: a launch a solve
           "prep_consts": folded_prep_consts,
           "banded_sweeps": banded_sweeps,
           "banded_sweep_once": banded_sweep_once,
           "joint_cg": cg.solve}


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def touched_columns(bases, tile, *locs) -> int:
    """How many columns of a rank-space table the live lanes of window-
    local ranks `locs` (−1: none) reach, each window starting at its
    tile's base: the columns the function must read."""
    base = bases.long().repeat_interleave(tile)
    return int(torch.cat([(base + loc.long())[loc >= 0]
                          for loc in locs]).unique().numel())


def check_banded_contacts(label, state, cfg, shard=None):
    """2.8, the contact list in one launch, against its plain composition
    (`shard`: one rank's ground slots and chunked candidate lanes). Ids,
    keys, activity and rank rows identical, f32 fields within TABLE_TOL
    × extent. Returns (max err, kernel ms, plain ms, bound)."""
    n = state.num_bodies
    _, rank, cand, geom, _ = banded_inputs(state, cfg)

    def run(plain):
        return banded_contacts(state, cfg, rank, cand, geom, plain=plain,
                               shard=shard)
    (ck, lok, rbk, ng), (cp, lop, rbp, ngp) = run(False), run(True)
    if ng != ngp:
        raise AssertionError(f"{label}: ground slots {ng} != {ngp}")
    for f in ("body_a", "body_b", "key", "active"):
        if not torch.equal(getattr(ck, f), getattr(cp, f)):
            raise AssertionError(f"{label}: {f} differs")
    if not (torch.equal(lok, lop) and torch.equal(rbk, rbp)):
        raise AssertionError(f"{label}: rank rows differ")
    extent = float(geom[24:27, :n].abs().max())
    err = max(float((getattr(ck, f) - getattr(cp, f)).abs().max())
              for f in ("point", "normal", "depth", "friction",
                        "restitution"))
    if not err <= TABLE_TOL * extent:
        raise AssertionError(f"{label}: f32 fields |Δ| {err}")
    # the work of this call: its ground slots' bodies (pos, quat, half
    # extents, inverse mass, shape type, friction, restitution, rank: 15
    # words a body) and their corners; its candidate lanes (mask, ranks,
    # ids) and the body-table rows 24:43 of the bodies its live lanes
    # reach, with the manifold of each live lane; the contact list written
    size = shard.size if shard is not None else 1
    r = shard.rank if shard is not None else 0
    kg = ng // n if shard is None else min(cfg.max_contacts_per_pair, 8)
    g_bodies = len(set(g % n for g in range(r * ng, min((r + 1) * ng,
                                                         kg * n))))
    p_loc = -(-cand.mask.shape[0] // size)
    sl = slice(r * p_loc, (r + 1) * p_loc)
    cand_l = PairCandidates(*[x if x.dim() == 0 else x[sl] for x in cand])
    bases, la, lb, tile, _ = pair_operands(state, cand_l, cfg, geom,
                                           shard is not None)
    live = int((la >= 0).sum())
    cols = touched_columns(bases, tile, la, lb)
    bnd = bound(15 * 4 * g_bodies + 17 * cand_l.mask.numel()
                + 19 * 4 * cols + nbytes(*ck, lok, rbk),
                OPS_GROUND_BODY * g_bodies + OPS_BOX_MANIFOLD * live)
    kms, pms = median_ms(lambda: run(False), 20), median_ms(
        lambda: run(True), 3)
    log(f"{label}: ids/keys/activity/rank rows identical, f32 fields max "
        f"|Δ| {err}; {ng} ground slots ({int(ck.active[:ng].sum())} "
        f"active), {cand_l.mask.numel()} lanes, {live} live reaching "
        f"{cols} bodies, {int(ck.active[ng:].sum())} active pair slots; "
        f"kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.5f} ms "
        f"({bnd[1]})")
    return err, kms, pms, bnd


def folded_consts_check(label, got, ref, touch) -> float:
    """2.6 folded into a sweep 0: the constants it wrote for the touched
    slots against prep_consts_plain's, bit for bit. Returns 0.0."""
    if not torch.equal(got[:, touch], ref[:, touch]):
        bad = (got[:, touch] != ref[:, touch]).any(1).nonzero().flatten()
        raise AssertionError(f"2.6 folded into {label}: constant rows "
                             f"{bad.tolist()} differ from prep_consts_plain")
    return 0.0


def check_np_kernels(state, cfg):
    """Phase 7: the two-kernel path's kernels (2.8; 2.5 with 2.6 in its
    sweep 0) against their plain versions at the path's shapes. Returns
    ({name: (max_abs_err, ms, plain_ms, bound)}, [Solve])."""
    n = state.num_bodies
    out = {}
    out["pair_manifolds_banded"] = check_banded_contacts(
        "2.8 banded contacts", state, cfg)
    contacts, ranks, _, geom, cand, cp = banded_contact_list(state, cfg)

    ops = banded_operands(state, contacts, cfg,
                          (state.contact_key, state.contact_lam), ranks, cp)
    pk = prep_kw(cfg, ops.use_split)
    cpl = prep_consts_plain(geom, ops.bases, ops.la, ops.lb, ops.cin,
                            tile=ops.tile, **pk)
    touch = ops.la >= 0
    n_touch = int(touch.sum())
    z0 = banded_z0(geom)
    pos_iters = cfg.position_iters if ops.use_split else 0
    sweeps = max(cfg.contact_iters, pos_iters) + 1

    def sw_run(plain, consts_out=None):
        return banded_sweeps(z0, ops.bases, ops.la, ops.lb, geom, ops.cin,
                             tile=ops.tile, vel_iters=cfg.contact_iters,
                             pos_iters=pos_iters, consts_out=consts_out,
                             plain=plain, **pk)
    ck = torch.full_like(cpl, float("nan"))
    (zk, lk, _), (zp, lp, _) = sw_run(False, ck), sw_run(True)
    err_c = folded_consts_check("2.5's sweep 0 (two-kernel pile)", ck, cpl,
                                touch)
    err = max(row_check("sweeps z", zk[:, :n], zp[:, :n], SOLVE_RTOL),
              row_check("sweeps lam", lk, lp, SOLVE_RTOL))
    # what 2.6 + 2.5 must move: z0's (v, ω), the lane operands, every
    # slot's activity and the other cin rows of the touched slots, the 24
    # solve rows of the bodies they reach; z's velocities, pseudo-
    # velocities and degrees, and λ written. 2.6 for the touched slots,
    # sweep 0 for them, later sweeps for the live
    live = live_count(cpl, ops.use_split)
    cols = touched_columns(ops.bases, ops.tile, ops.la, ops.lb)
    bnd = bound(nbytes(z0[0:6, :n], ops.bases, ops.la, ops.lb, zk[0:6, :n],
                       zk[8:15, :n], lk) + 4 * cp
                + 4 * (CIN_ROWS - 1) * n_touch + 4 * 24 * cols,
                OPS_SOLVE_PREP * n_touch
                + OPS_SOLVE_CONTACT * (n_touch + (sweeps - 1) * live))
    kms, pms = median_ms(lambda: sw_run(False), 20), median_ms(
        lambda: sw_run(True), 3)
    log(f"2.5 banded sweeps with 2.6 in sweep 0 ({sweeps} sweeps, tile "
        f"{ops.tile}, warm {ops.use_split}): constants of the {n_touch} "
        f"touched slots bit for bit prep_consts_plain's; max |Δ| {err}; "
        f"kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.5f} ms "
        f"({bnd[1]}); {live} live of {cp} slots (band overflow "
        f"{int(ops.band_overflow)}, capacity overflow "
        f"{int(ops.cap_overflow)}); grid "
        f"{solve_plan(False, cp, geom.device)}")
    out["banded_sweeps"] = (err, kms, pms, bnd)
    # 2.6's own row: its plain version's time, its bound (cin and the
    # geometry gathers in, the constants out once), the time of the 2.5
    # launch it now runs in
    pms6 = median_ms(lambda: prep_consts_plain(
        geom, ops.bases, ops.la, ops.lb, ops.cin, tile=ops.tile, **pk), 3)
    bnd6 = bound(nbytes(ops.bases, ops.la, ops.lb) + 4 * cp
                 + 4 * (CIN_ROWS - 1) * n_touch + 4 * 24 * cols
                 + 4 * R_PREP * n_touch, OPS_SOLVE_PREP * n_touch)
    out["prep_consts"] = (err_c, kms, pms6, bnd6)
    return out, [Solve("banded_sweeps", "two-kernel pile",
                       lambda: sw_run(False), kms, bnd, live)]


def drive(label, make, cfg, steps, want, gpu, zero_overflow=False):
    """prepare_contacts + `steps` fresh steps with the launch counters set
    to 0 just before and read just after (`want` names the counts that
    are not 0); the checks (with `zero_overflow`, pair and contact
    overflow 0 at the end) and the step rate, then two steps of the
    kernel path against the plain path. Returns (launch counts, the last
    state)."""
    zero_counts()
    st = prepare_contacts(make(), cfg)
    # the rebuild period the path really has (1 off the anchored paths)
    k_eff = cfg.contact_rebuild if anchored_path(st, cfg) else 1
    window0 = min(40, steps // 2)
    torch.cuda.synchronize()
    host = {"rebuild": [], "refresh": []}
    for i in range(steps):
        if i == window0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ts = time.perf_counter()
        kind = "refresh" if st.step_count_host % k_eff else "rebuild"
        st, m = step_with_metrics(st, cfg)
        if i >= window0:
            host[kind].append(1e3 * (time.perf_counter() - ts))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    want = {name: want.get(name, 0) for name in launches}   # unnamed: 0
    log(f"{label}: launches over {steps} steps: {launches}")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    for name in ("pos", "quat", "vel", "omega"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"{label}: non-finite {name} after the run")
    n = st.num_bodies
    timed = steps - window0
    log(f"{label}: state finite; pair_overflow {int(m['pair_overflow'])}, "
        f"contact_overflow {int(m['contact_overflow'])}, band_overflow "
        f"{int(m['band_overflow'])}, max_penetration "
        f"{float(m['max_penetration']):.4f}, contacts "
        f"{int(m['contact_count'])}")
    if int(m["band_overflow"]) != 0:
        raise AssertionError(f"{label}: band_overflow {int(m['band_overflow'])}")
    if zero_overflow and (int(m["pair_overflow"]) or int(m["contact_overflow"])):
        raise AssertionError(f"{label}: overflow counters not 0 at the end")
    log(f"{label}: {1e3 * secs / timed:.4f} ms/step, "
        f"{n * timed / secs:.1f} body-steps/s over steps {window0}..{steps} "
        f"on {gpu}")
    # host time to issue each step (no sync inside the window): median and
    # 90th percentile per branch
    for kind, ms in host.items():
        if not ms:
            continue
        ms.sort()
        log(f"{label}: {kind} steps issue in {ms[len(ms) // 2]:.4f} ms "
            f"median, {ms[9 * len(ms) // 10]:.4f} ms p90 ({len(ms)} steps)")
    # kernel path against plain path from identical states: one rebuild
    # step (step_count % K == 0) and one refresh step on an anchored path,
    # else one cold step (the warm buffers of a fresh scene: no warm start,
    # no position sweeps) and one warm step (the live keys of the run)
    if k_eff > 1:
        while st.step_count_host % k_eff:
            st, _ = step_with_metrics(st, cfg)
        kinds = ("rebuild", "refresh")
    else:
        kinds = ("cold", "warm")
    for what in kinds:
        src = st
        if what == "cold":
            src = st.replace(contact_key=st.contact_key.new_zeros((0,)),
                             contact_lam=st.contact_lam.new_zeros((3, 0)))
        sk = steps_match(f"{label} {what} step {st.step_count_host}", src,
                         cfg)
        if what != "cold":
            st = sk
    return launches, st


# ---------------------------------------------------------------------------
# phases 8-10: the contact table's candidate-free modes, the hull faces
# ---------------------------------------------------------------------------

def kernel_device_split(fn, names, reps: int = 5) -> dict:
    """{kernel: mean device µs a call of fn spends in it} over the kernels
    whose names contain one of `names` (torch.profiler over `reps` calls;
    run with the profiles, after every timed window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and any(k in e.key
                                                    for k in names):
            by[re.search(KERNEL_NAME, e.key).group(0)] += \
                e.self_device_time_total / reps
    return dict(by)


def kernel_device_us(fn, names, reps: int = 5) -> float:
    """Mean device µs a call of fn spends in the kernels whose names
    contain one of `names`."""
    return sum(kernel_device_split(fn, names, reps).values())


# The persistent solve's design levers: each a variant of
# csrc/banded_solve.cu made by replacing text in a copy of it (timing
# only; no_atomics gives wrong results): no_hold reads every live
# contact's constants from global memory in every sweep, scalar gathers
# and scatters z one float at a time, in_order gives each block a range
# of slots in slot order, grid_all launches every resident block and
# grid_slots one a 256 slots (not at least one an SM), no_atomics adds
# nothing to z in the later sweeps.
_SCATTER4 = """\
  if (vel) atomicAdd(reinterpret_cast<float4*>(row), make_float4(dv.x, dv.y, dv.z, dw.x));
  if (vel && pseudo) {
    atomicAdd(reinterpret_cast<float4*>(row + 4), make_float4(dw.y, dw.z, pdv.x, pdv.y));
  } else if (vel) {
    atomicAdd(reinterpret_cast<float2*>(row + 4), make_float2(dw.y, dw.z));
  } else if (pseudo) {
    atomicAdd(reinterpret_cast<float2*>(row + 6), make_float2(pdv.x, pdv.y));
  }
  if (pseudo) atomicAdd(reinterpret_cast<float4*>(row + 8), make_float4(pdv.z, pdw.x, pdw.y, pdw.z));
"""
_SCATTER1 = """\
  const float v[6] = {dv.x, dv.y, dv.z, dw.x, dw.y, dw.z};
  const float pv[6] = {pdv.x, pdv.y, pdv.z, pdw.x, pdw.y, pdw.z};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (vel) atomicAdd(row + k, v[k]);
    if (pseudo) atomicAdd(row + 6 + k, pv[k]);
  }
"""
_WANT = "const int want = by_slots > sms[dev] ? by_slots : sms[dev];"
LEVERS = {
    "no_hold": [("const int cap = budget[dev] / (kRec * 4);",
                 "const int cap = 0;")],
    "scalar": [("return __ldcg(reinterpret_cast<const float4*>(zt + "
                "(size_t)rank * kZRows) + q);",
                "const float* r = zt + (size_t)rank * kZRows + 4 * q;\n"
                "  return make_float4(__ldcg(r), __ldcg(r + 1), "
                "__ldcg(r + 2), __ldcg(r + 3));"),
               (_SCATTER4, _SCATTER1)],
    "in_order": [("(int)((size_t)(g * l.cpb + k) * l.deal % n_chunks)",
                  "g * l.cpb + k")],
    "grid_all": [(_WANT, "const int want = gmax;")],
    "grid_slots": [(_WANT, "const int want = by_slots;")],
    "no_atomics": [("    scatter(zw, rank, dv, dw, true, pdv, pdw, pseudo, "
                    "0.f);\n", "")],
}


def lever_libraries() -> dict:
    """{lever: the port's entry points with the persistent solve's from
    its variant}, the variants built into the build directory, one nvcc
    each, all at once."""
    import ctypes
    from types import SimpleNamespace

    src = (_build.CSRC / "banded_solve.cu").read_text()
    out = _build.BUILD_DIR / "levers"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in LEVERS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"lever {name}: {old!r} is not in "
                                     f"banded_solve.cu once")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on lever {name}:\n{text}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        ns = SimpleNamespace(**vars(_build.library()))
        for entry in ("bs_banded_solve", "bs_banded_sweeps", "bs_solve_plan"):
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            setattr(ns, entry, fn)
        libs[name] = ns
    return libs


def solve_levers(solves, gpu) -> None:
    """Device µs a call of each 2.3 and 2.5 solve under each lever, in
    turns: the port's build, every variant, the port's build again."""
    port = _build.library
    libs = lever_libraries()
    try:
        for s in solves:
            if s.name == "banded_sweep_once":
                continue
            us = {}
            for name in ["design", *libs, "design"]:
                _build.library = (lambda ns=libs[name]: ns) \
                    if name in libs else port
                us.setdefault(name, []).append(
                    kernel_device_us(s.call, ("solve_kernel",)))
            log(f"levers {s.name} ({s.label}), device us a call: "
                f"{json.dumps(us)} ({gpu})")
    finally:
        _build.library = port


def mode_bound(st, cfg, geom, prev, outs, gate):
    """The least time of a candidate-free table call on these inputs: the
    fired buckets' window geometry (narrow-phase rows of their ranks and
    the bp_k after), the previous keys and impulses, the persisted blocks
    of the passed-through buckets read; the outputs written. Operations:
    per fired bucket its window AABBs and raw pair tests, the prefilter
    on its stage-1 lanes, the manifold on its SAT lanes, its ground
    corners; the emission of each active contact. Also returns the SAT
    lanes of the fired buckets."""
    n = st.num_bodies
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
        la2, _, _ = obb_prefilter(ga, gb, la, lb, kw["cap2"], False)
        sat = int((la2[fired] >= 0).sum())
    cols = torch.zeros(geom.shape[1], dtype=torch.bool, device=geom.device)
    for b in torch.nonzero(fired).flatten().tolist():
        cols[b * BLOCK:b * BLOCK + BLOCK + bp_k] = True
    cols[n:] = False
    f = int(fired.sum())
    table, _, _ = outs
    passed = (table.shape[0] * 4 * ccap * (nb - f)) if gate is not None else 0
    act = int((table[CT_ACT] > 0).sum())
    return bound(24 * 4 * int(cols.sum()) + passed + nbytes(*prev, *outs),
                 f * (OPS_WINDOW_AABB * (BLOCK + bp_k) + OPS_RAW_PAIR
                      * BLOCK * bp_k + OPS_GROUND_BODY * BLOCK)
                 + (OPS_OBB_PREFILTER * stage1 if kw["cap2"] else 0)
                 + OPS_BOX_MANIFOLD * sat + OPS_EMIT * act), sat


def check_table_modes(label, st, cfg, order, cases):
    """2.2 without candidates (the in-kernel broad phase on `order`, None
    for the identity) against its plain version, each case a gate [NB]
    over the persisted table or None (ungated). Returns {case: (max err,
    kernel ms, plain ms, bound, fired buckets, the kernel call)}."""
    n = st.num_bodies
    geom = unified_geom(st, cfg, order)
    prev = (st.contact_key, st.contact_lam)
    out = {}
    for case, gate in cases.items():
        g = None if gate is None else (gate, st.contact_table)

        def fn(plain, g=g):
            return bucket_contact_table(st, None, cfg, prev=prev, geom=geom,
                                        plain=plain, gate=g)
        outs, err, kms, pms, act = check_table(
            f"2.2 {label} {case}", lambda fn=fn: fn(False),
            lambda fn=fn: fn(True), n, geom)
        bnd, sat = mode_bound(st, cfg, geom, prev, outs, gate)
        meta = outs[1][0].reshape(-1, BLOCK)
        fired = meta.shape[0] if gate is None else int(gate.sum())
        log(f"2.2 {label} {case} ({fired} of {meta.shape[0]} buckets "
            f"fired): keys/activity/ranks/meta/warm identical, f32 rows max "
            f"|Δ| {err}; {act} contacts, {sat} SAT lanes, dropped "
            f"{int(meta[:, 0].sum())}, lane drops {int(meta[:, 2].sum())}, "
            f"window-edge ranks {int(meta[:, 3].sum())}; kernel {kms:.4f} "
            f"ms, plain {pms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})")
        out[case] = (err, kms, pms, bnd, fired, lambda fn=fn: fn(False))
    return out


def steps_match(label, st, cfg):
    """One step of the kernel path against the plain path from `st`."""
    sk, mk = step_with_metrics(st, cfg)
    sp, mp = step_with_metrics(st, cfg, plain=True)
    state_close(sk, sp, label)
    for key in ("contact_count", "pair_overflow", "contact_overflow"):
        if int(mk[key]) != int(mp[key]):
            raise AssertionError(f"{label}: {key} differs")
    log(f"{label}: kernel path matches plain path (atol {STEP_ATOL}); "
        f"contacts {int(mk['contact_count'])}")
    return sk


def squeezed_rain(verts, n, dev):
    """hull_rain(verts, n) pressed together so hulls touch from the start,
    prepared for rain_config(n) and stepped twice along the plain path."""
    arrays = to_numpy(scenes.hull_rain(verts, n, device="cpu"))
    arrays["pos"] *= np.float32([0.55, 0.45, 0.55])
    arrays["pos"][:, 1] += 0.3
    cfg = scenes.rain_config(n)
    st = prepare_contacts(state_from_arrays(arrays, dev), cfg)
    for _ in range(2):
        st, _ = step_with_metrics(st, cfg, plain=True)
    return st, cfg


def check_hull_faces(dev):
    """Phase 10: 2.4 on libraries of faces of 3, 6, 12, 20 and 63
    vertices, and the motion guard's rebuilds. Returns the max err."""
    err = 0.0
    hulls = {}
    for label, verts in (("octahedra, E=3", octahedron_verts()),
                         ("hexagonal prisms, E=6", prism_verts(6)),
                         ("12-gon prisms, E=12", prism_verts(12)),
                         ("20-gon prisms, E=20", prism_verts(20)),
                         ("63-gon prisms, E=63", prism_verts(63))):
        st, cfg = squeezed_rain(verts, 128, dev)
        e = ht.hull_dims(st.hulls).e
        (tk, _, _), _, _, e_err, _, _, _ = check_hull_table(st, cfg, label)
        pairs = int((tk[CT_ACT] * (1 - tk[CT_KSGN])).sum())
        if e != int(label.split("=")[1]) or pairs == 0:
            raise AssertionError(f"{label}: E {e}, {pairs} pair contacts")
        err = max(err, e_err)
        hulls[label] = st
    st = hulls["octahedra, E=3"]
    gcfg = scenes.rain_config(128).replace(contact_rebuild_vel_factor=2.0)
    fires, checked = 0, False
    for _ in range(12):
        guard = st.step_count_host % 4 != 0 and _rebuild_now(st, gcfg, True)
        fires += guard
        if guard and not checked:
            steps_match(f"hull guard step {st.step_count_host} (octahedra)",
                        st, gcfg)
            checked = True
        st, _ = step_with_metrics(st, gcfg)
    log(f"hull motion guard (octahedra, vel_factor 2): {fires} guard "
        f"rebuilds in 12 steps besides the scheduled ones")
    if not checked:
        raise AssertionError("hull motion guard never fired")
    return err


# ---------------------------------------------------------------------------
# phase 11: the row-sharded step
# ---------------------------------------------------------------------------

SWEEP_CASES = {      # (vel_on, pos_on, warm, deg_pass) of one sharded sweep
    "sweep 0 (degrees, warm start)": (False, False, True, True),
    "velocity + position": (True, True, False, False),
    "velocity only": (True, False, False, False),
    "position only": (False, True, False, False),
}


def unfused(cfg):
    """The solve the sharded step runs: the unfused table solve, rebuilt
    every step, with the split-impulse pose update."""
    return cfg.replace(contact_rebuild=1, fuse_prep=False,
                       fuse_integrate=False)


def table_sweep_operands(state, cfg):
    """The sharded table solve's operands from this state (the unfused
    solve, warm): (z0, bases, la, lb, geom, cin, tile, the constants'
    keywords but use_split)."""
    n = state.num_bodies
    ucfg = unfused(cfg)
    table, _, geom, warm, _ = _rebuild(state, ucfg, True, plain=False)
    bases, la, lb, cin = table_solve_operands(table, warm, n, ucfg)
    ccap = table_shape(n, ucfg)[1]
    kw = prep_kw(ucfg, True)
    del kw["use_split"]
    return banded_z0(geom), bases, la, lb, geom, cin, ccap, kw


def np_sharded_operands(state, cfg):
    """The sharded two-kernel solve's operands from this state, at the
    capacity the ranks round up to: (z0, bases, la, lb, geom, cin, tile,
    the constants' keywords but use_split)."""
    n = state.num_bodies
    contacts, ranks, _, geom, _, _ = banded_contact_list(state, cfg)
    cp = _sharded_capacity(n, contacts.body_a.shape[0], cfg,
                           Shard(None, 0, RANKS))
    warm = ((state.contact_key, state.contact_lam)
            if tuple(state.contact_key.shape) == (cp,) else None)
    ops = banded_operands(state, contacts, cfg, warm, ranks, cp)
    kw = prep_kw(cfg, True)
    del kw["use_split"]
    return (banded_z0(geom), ops.bases, ops.la, ops.lb, geom, ops.cin,
            ops.tile, kw)


def clone_scratch(sc):
    return type(sc)(*[t.clone() for t in sc])


def check_sweep_once(label, n, z0, bases, la, lb, geom, cin, tile, pk,
                     timed=True):
    """2.7 against its plain version on rank 0's quarter of a sharded
    solve's tiles (its columns of cin read in place), each switch
    combination: sweep 0 from z0 on a fresh scratch, the constants it
    builds (2.6 folded in) bit for bit prep_consts_plain's, a later sweep
    (2) from the plain loop's scratch after sweep 0 and one velocity
    sweep. The delta table and λ within SOLVE_RTOL, the live list (as a
    set) and the next snapshot table identical. Returns (max err, ms,
    plain ms, bound) of the velocity + position sweep, the one the
    schedule runs most (times None unless `timed`), and the Solves of
    sweep 0 and of that sweep (none unless `timed`)."""
    t_loc = bases.shape[0] // RANKS
    c_loc = t_loc * tile
    npad = z0.shape[1]
    ops = (bases[:t_loc], la[:c_loc], lb[:c_loc], geom, cin[:, :c_loc])
    touch = (ops[1] >= 0) | (ops[2] >= 0)
    n_touch = int(touch.sum())
    # the bodies the rank's contacts reach
    cols = touched_columns(ops[0], tile, ops[1], ops[2])
    base = sweep_scratch(c_loc, npad, z0.device)
    for sweep, vel in ((0, False), (1, True)):
        banded_sweep_once(base, z0, *ops, sweep=sweep, tile=tile,
                          vel_on=vel, pos_on=False, use_split=True,
                          plain=True, **pk)
    n_live = int(base.count[0])
    log(f"2.7 operands ({label}): {la.shape[0]} contacts, tile {tile}, "
        f"{bases.shape[0]} tiles, {t_loc} a rank; rank 0: {n_touch} with "
        f"an endpoint reaching {cols} bodies, {n_live} live after sweep 0")
    out = {}
    solves = []
    for case, (vel_on, pos_on, warm_on, deg) in SWEEP_CASES.items():
        sweep = 0 if deg else 2

        def start(deg=deg):
            return (sweep_scratch(c_loc, npad, z0.device) if deg
                    else clone_scratch(base))

        def run(plain, sc, sweep=sweep, v=vel_on, p=pos_on, w=warm_on,
                consts_out=None):
            banded_sweep_once(sc, z0, *ops, sweep=sweep, tile=tile,
                              vel_on=v, pos_on=p, use_split=w,
                              consts_out=consts_out, plain=plain, **pk)
        sk, sp = start(), start()
        ck = torch.full((R_PREP, c_loc), float("nan"), device=z0.device)
        run(False, sk, consts_out=ck if deg else None)
        run(True, sp)
        if deg:
            folded_consts_check(f"2.7's sweep 0 ({label} rank 0)", ck,
                                prep_consts_plain(
                                    geom, *ops[:3], ops[4], tile=tile,
                                    use_split=warm_on, **pk),
                                touch)
        m = int(sp.count[0])
        if not (int(sk.count[0]) == m and torch.equal(
                torch.sort(sk.live[:m]).values, sp.live[:m])):
            raise AssertionError(f"2.7 {label} {case}: live lists differ")
        if not torch.equal(sk.zt[sweep % 2], sp.zt[sweep % 2]):
            raise AssertionError(f"2.7 {label} {case}: snapshot tables "
                                 f"differ")
        err = max(row_check(f"2.7 {label} {case} dz",
                            rows_of(sk.dz[sweep % 3])[:, :n],
                            rows_of(sp.dz[sweep % 3])[:, :n], SOLVE_RTOL),
                  row_check(f"2.7 {label} {case} lam", sk.lam, sp.lam,
                            SOLVE_RTOL))
        if not timed:
            log(f"2.7 banded sweep once ({label}), {case}: max |Δ| {err}; "
                f"live list and snapshot table identical"
                f"{'; constants bit for bit' if deg else ''}")
            out[case] = (err, None, None, None)
            continue
        if deg:
            # every slot's endpoints and activity, the touched slots'
            # other cin rows and the 24 solve rows of the bodies they
            # reach (2.6 folded in); λ of every slot, the live list with
            # its ends and its slots' sweep constants, the delta's data
            # rows at the bodies reached and the first snapshot table
            # (z0's v, ω in) written
            bnd = bound(nbytes(*ops[:3], z0[0:6, :n]) + 4 * c_loc
                        + 4 * (CIN_ROWS - 1) * n_touch + 4 * 24 * cols
                        + 16 * c_loc + 4 * (3 + R_SWEEP) * m
                        + 13 * 4 * cols + 16 * 4 * n,
                        (OPS_SOLVE_PREP + OPS_SOLVE_CONTACT) * n_touch)

            def timed_call(plain, run=run, start=start):
                run(plain, start())
        else:
            # the live contacts' sweep constants (no λ₀), endpoints, list
            # entry and relaxation, their λ read and written; the next
            # snapshot (the two tables' data rows read, one written, over
            # the bodies) and the delta at the bodies reached
            bnd = bound(4 * ((R_PREP - 3) + 4 + 8) * m + 3 * 13 * 4 * n
                        + 12 * 4 * cols, OPS_SOLVE_CONTACT * m)
            sk_t, sp_t = clone_scratch(base), clone_scratch(base)

            def timed_call(plain, run=run, sk_t=sk_t, sp_t=sp_t):
                run(plain, sp_t if plain else sk_t)
        kms = median_ms(lambda: timed_call(False), 50)
        pms = median_ms(lambda: timed_call(True), 5)
        if deg or case == "velocity + position":
            solves.append(Solve(
                "banded_sweep_once", f"{label} rank 0 of {RANKS}, {case}",
                lambda f=timed_call: f(False), kms, bnd,
                n_touch if deg else m))
        log(f"2.7 banded sweep once ({label}), {case}: max |Δ| {err}, live "
            f"list and snapshot table identical"
            f"{'; constants bit for bit' if deg else ''}; kernel {kms:.4f} ms"
            f"{' with its scratch zeroing' if deg else ''}, plain "
            f"{pms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})")
        out[case] = (err, kms, pms, bnd)
    err = max(v[0] for v in out.values())
    return (err,) + out["velocity + position"][1:], solves


def check_bucket_ranges(state, cfg, hulls: bool, label: str) -> None:
    """The table kernel over each rank's bucket range equals the
    full-range kernel's block of those buckets, bit for bit."""
    n = state.num_bodies
    fn = ht.bucket_hull_contact_table if hulls else bucket_contact_table
    aabbs = body_aabbs(state)
    order = sweep_order(state, aabbs)
    cand = pair_candidates(state, cfg, aabbs, order)
    geom = unified_geom(state, cfg, order, hulls=hulls)
    prev = (state.contact_key, state.contact_lam)
    full = fn(state, cand, cfg, prev=prev, geom=geom)
    nb, ccap, _ = table_shape(n, cfg)
    nb_l = nb // RANKS
    cap = cand.mask.shape[0] // nb
    for r in range(RANKS):
        b0 = r * nb_l
        lanes = slice(b0 * cap, (b0 + nb_l) * cap)
        cols = slice(b0 * ccap, (b0 + nb_l) * ccap)
        part = fn(state, type(cand)(*[x[lanes] if x.dim() else x
                                      for x in cand]), cfg,
                  prev=(prev[0][:, cols], prev[1][:, cols]), geom=geom,
                  buckets=(b0, nb_l))
        blocks = (full[0][:, cols], full[1][:, b0 * BLOCK:(b0 + nb_l) * BLOCK],
                  full[2][:, cols])
        for got, ref in zip(part, blocks):
            if not torch.equal(got, ref):
                raise AssertionError(f"{label}: bucket range {b0}..{b0 + nb_l}"
                                     f" differs from the full table")
    log(f"{label}: the kernel over each of {RANKS} bucket ranges of {nb_l} "
        f"buckets equals the full-range kernel's block, bit for bit")


def sharded_configs():
    """path → config of the row-sharded drives: the configs of phases 4,
    5 and 7."""
    pile_cfg = scenes.pile_config(N_PILE).replace(contact_iters=8)
    return {"sharded_pile": pile_cfg,
            "sharded_rain": scenes.rain_config(N_RAIN),
            "sharded_two_kernel_pile": pile_cfg.replace(contact_table=False)}


def sharded_rank(shard, steps: int, states):
    """One rank of the sharded drives: for each path, from the state that
    path's one-process drive ended with (prepared, warm keys live),
    `steps` row_sharded_step steps with the launch counts set to 0 just
    before and read just after, timed after 8 steps; then one more step
    through step_with_metrics with the shard. Returns {path: (launches,
    ms/step, the extra step's metrics, state before and after it, its
    counters)}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    warm_up = min(8, steps // 2)
    out = {}
    for name, cfg in sharded_configs().items():
        step = row_sharded_step(cfg)
        st = state_from_arrays(states[name], dev)
        zero_counts()
        for i in range(steps):
            if i == warm_up:
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            st = step(st)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / (steps - warm_up)
        launches = read_counts()
        before = to_numpy(st)
        # the same step with its metrics
        st, m = step_with_metrics(st, cfg, shard=shard)
        out[name] = (launches, ms, {k: float(v) for k, v in m.items()},
                     before, to_numpy(st),
                     {k: int(m[k]) for k in STEP_COUNTERS})
    out["probes"] = rank_probes(shard, dev)
    return out


def rank_probes(shard, dev, reps: int = 50):
    """What a sweep of the sharded solve costs on this rank while all the
    ranks run the same loop: ms per call, each call ending in a
    synchronize, of the all-reduce of a delta table [NPAD, 16] as the
    solve makes it (host-staged under gloo), of its host round trip alone
    (device → host → device copies), and of one later 2.7 launch on a
    quarter of the 4k pile's slots (none live: its table work alone)."""
    npad = 4352
    n_c = 6144
    zeros = torch.zeros((n_c,), dtype=torch.int32, device=dev)
    ops = (torch.zeros((n_c // 768,), dtype=torch.int32, device=dev), zeros,
           zeros, torch.zeros((48, npad), device=dev),
           torch.zeros((CIN_ROWS, n_c), device=dev))
    z0 = torch.zeros((16, npad), device=dev)
    sc = sweep_scratch(n_c, npad, dev)
    kw = dict(use_split=False, baum_over_dt=0.0, slop=0.0, relaxation=0.0)
    banded_sweep_once(sc, z0, *ops, sweep=0, tile=768, vel_on=False,
                      pos_on=False, **kw)
    dz = sc.dz[0]

    def timed(fn):
        for i in range(reps + 5):
            if i == 5:
                torch.distributed.barrier()
                t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps
    return {
        "all_reduce": timed(lambda: all_reduce_sum(dz, shard)),
        "host_round_trip": timed(lambda: dz.copy_(dz.cpu())),
        "sweep_once": timed(lambda: banded_sweep_once(
            sc, z0, *ops, sweep=1, tile=768, vel_on=True, pos_on=True,
            **kw)),
    }


def run_sharded(steps: int, gpu: str, states):
    """Phase 8's drives from `states` (path → state arrays): spawn the
    ranks, check what they return. Returns {path: launch counts summed
    over the ranks}."""
    n_dev = torch.cuda.device_count()
    backend = "nccl" if n_dev >= RANKS else "gloo"
    where = (f"{RANKS} ranks, one card each, over NCCL" if backend == "nccl"
             else f"{RANKS} ranks sharing one {gpu} over gloo")
    log(f"sharded: {where} ({n_dev} card(s) visible); gloo stages every "
        f"collective's CUDA tensors through the host")
    t0 = time.perf_counter()
    ranks = launch(sharded_rank, RANKS, (steps, states), backend=backend)
    log(f"sharded: {RANKS} ranks ran in {time.perf_counter() - t0:.1f} s "
        f"(spawn and set-up included)")
    for what in ranks[0]["probes"]:
        times = " ".join(f"{r['probes'][what]:.4f}" for r in ranks)
        log(f"sharded: ms per {what} (synchronized), ranks 0..{RANKS - 1} "
            f"at once: {times}")
    dev = torch.device("cuda", torch.cuda.current_device())
    summed = {}
    for name, cfg in sharded_configs().items():
        # warm from the first step: prepare_contacts sized the keys
        sweeps = 1 + max(cfg.contact_iters, cfg.position_iters)
        launches = {k: sum(r[name][0][k] for r in ranks)
                    for k in ranks[0][name][0]}
        per_rank = {"sweep_window_masks": steps,
                    "prep_consts": steps,
                    "banded_sweep_once": steps * sweeps,
                    {"sharded_pile": "bucket_contact_table",
                     "sharded_rain": "bucket_hull_contact_table",
                     "sharded_two_kernel_pile": "pair_manifolds_banded"}[name]:
                    steps}
        want = {k: RANKS * per_rank.get(k, 0) for k in launches}
        log(f"{name}: launches over {steps} steps, summed over the ranks: "
            f"{launches}")
        if launches != want:
            raise AssertionError(f"{name}: launch counts {launches} != {want}")
        _, ms, m, before, after, counters = ranks[0][name]
        for r in range(1, RANKS):
            for k in before:
                for a, b in ((ranks[r][name][3], before),
                             (ranks[r][name][4], after)):
                    if not np.array_equal(a[k], b[k]):
                        raise AssertionError(
                            f"{name}: rank {r}'s {k} differs from rank 0's")
        for k in ("pos", "quat", "vel", "omega"):
            if not np.isfinite(before[k]).all():
                raise AssertionError(f"{name}: non-finite {k}")
        log(f"{name}: every rank's state bitwise equal to rank 0's; state "
            f"finite; pair_overflow {int(m['pair_overflow'])}, "
            f"contact_overflow {int(m['contact_overflow'])}, band_overflow "
            f"{int(m['band_overflow'])}, contacts {int(m['contact_count'])}")
        if int(m["band_overflow"]) != 0:
            raise AssertionError(f"{name}: band_overflow {m['band_overflow']}")
        log(f"{name}: {' '.join(f'{r[name][1]:.4f}' for r in ranks)} "
            f"ms/step on ranks 0..{RANKS - 1} ({where})")
        # one more sharded step against the one-process kernel path
        src = state_from_arrays(before, dev)
        sk, mk = step_with_metrics(src, unfused(cfg))
        sh = state_from_arrays(after, dev)
        state_close(sh, sk, f"{name} warm step")
        if counters != {k: int(mk[k]) for k in STEP_COUNTERS}:
            raise AssertionError(f"{name} warm step: counters {counters} != "
                                 f"{ {k: int(mk[k]) for k in STEP_COUNTERS} }")
        log(f"{name} warm step: matches the one-process kernel path (atol "
            f"{STEP_ATOL}; keys and counters identical)")
        summed[name] = launches
    return summed


# ---------------------------------------------------------------------------
# phase 12: the device rollout (captured CUDA graphs)
# ---------------------------------------------------------------------------

def clone_state(st):
    return st.replace(**{f.name: getattr(st, f.name).clone()
                         for f in dataclasses.fields(st)
                         if isinstance(getattr(st, f.name), torch.Tensor)})


def replay_close(got, ref, what) -> None:
    """A replayed step against the eager step from the same state:
    integer fields identical, f32 within STEP_ATOL, λ within SOLVE_RTOL
    of each row's largest magnitude."""
    state_close(got, ref, what)
    for name in ("contact_order", "contact_meta", "step_count"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"{what}: {name} differs")
    if got.step_count_host != ref.step_count_host:
        raise AssertionError(f"{what}: step_count_host differs")
    if got.contact_lam.numel():
        row_check(f"{what} lam", got.contact_lam, ref.contact_lam,
                  SOLVE_RTOL)
    if got.lam_joint.numel():
        row_check(f"{what} joint lam", got.lam_joint[None],
                  ref.lam_joint[None], SOLVE_RTOL)


def replay_agreement(label, st, cfg) -> dict:
    """2K + 2 steps of a DeviceStepper from `st` (3 with one branch),
    each replayed step against the eager step from a copy of the same
    state. Returns {branch: replayed steps checked}."""
    k_eff = cfg.contact_rebuild if anchored_path(st, cfg) else 1
    stepper = DeviceStepper(st, cfg)
    checked = collections.Counter()
    for _ in range(2 * k_eff + 2 if k_eff > 1 else 3):
        branch = rebuild_branch(stepper.state, cfg)
        if branch not in stepper.captured:
            stepper.step()
            continue
        ref, _ = step_with_metrics(clone_state(stepper.state), cfg)
        stepper.step()
        replay_close(stepper.state, ref,
                     f"{label} replayed step {ref.step_count_host - 1}")
        checked[{None: "step", True: "rebuild", False: "refresh",
                 GUARDED: "guarded"}[branch]] += 1
    if len(checked) != len(stepper.captured):
        raise AssertionError(f"{label}: replayed {dict(checked)} of "
                             f"{stepper.captured}")
    return dict(checked)


def time_rollout(label, make, cfg, steps, want, gpu):
    """From fresh scenes, in this process: `steps` eager steps and
    `steps` steps of a DeviceStepper, ms/step over steps 40..steps on the
    host clock ending in a synchronize; then rollout(steps,
    sample_every=steps // 6) with the launch counters set to 0 just
    before and read just after (they must equal `want`, the eager
    drive's), its samples finite and its last sample the final pose.
    Returns ({eager, replayed, rollout call ms/step}, launches, the
    replaying stepper)."""
    window0 = min(40, steps // 2)

    def timed(stepper):
        torch.cuda.synchronize()
        for i in range(steps):
            if i == window0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            stepper.step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (steps - window0)
    eager = timed(EagerStepper(prepare_contacts(make(), cfg), cfg))
    replayer = DeviceStepper(prepare_contacts(make(), cfg), cfg)
    replayed = timed(replayer)
    st = prepare_contacts(make(), cfg)
    every = steps // 6
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    final, (pos, quat) = rollout(st, cfg, steps, sample_every=every)
    torch.cuda.synchronize()
    call = 1e3 * (time.perf_counter() - t0) / steps
    launches = read_counts()
    want = {name: want.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"rollout {label}: launch counts {launches} "
                             f"!= {want}")
    if not (pos.shape[0] == steps // every and torch.equal(pos[-1], final.pos)
            and torch.equal(quat[-1], final.quat)
            and bool(torch.isfinite(pos).all() and torch.isfinite(quat).all())
            and final.step_count_host == steps):
        raise AssertionError(f"rollout {label}: samples wrong or not finite")
    ms = {"eager": eager, "replayed": replayed, "rollout_call": call}
    log(f"rollout {label}: eager {eager:.4f} ms/step, replayed "
        f"{replayed:.4f} ms/step over steps {window0}..{steps}; one "
        f"rollout({steps}, sample_every={every}) call {call:.4f} ms/step "
        f"(warm-up steps and captures included); launches through it "
        f"{launches}, as the eager drive's; {gpu}")
    return ms, launches, replayer


# ---------------------------------------------------------------------------
# phase 14: joints and compat (the demo scene, packed pendulums), and the
# hull motion guard decided on the device
# ---------------------------------------------------------------------------

def packed_pendulums(n_envs, dev, seed=2):
    """n_envs two-body pendulums (tests/test_pack_envs.py's: body 0 at
    (1, 0, 0) pinned to the origin, body 1 at (1, 2, 0) on a ball joint
    to it), each moved by uniform(-0.1, 0.1) from numpy's
    default_rng(seed), its pin with it, packed into one scene."""
    b = SceneBuilder()
    i0 = b.add_body(pos=(1.0, 0.0, 0.0), inertia=box_inertia((0.5,) * 3, 1.0))
    b.fix_to_point(i0, (0.0, 0.0, 0.0))
    i1 = b.add_body(pos=(1.0, 2.0, 0.0), inertia=box_inertia((0.3,) * 3, 1.0))
    b.ball_joint(i0, i1, anchor_a=(0, 1, 0), anchor_b=(0, -1, 0))
    off = torch.from_numpy(np.random.default_rng(seed).uniform(
        -0.1, 0.1, (n_envs, 1, 3)).astype(np.float32)).to(dev)
    batched = offset_envs(b.build(device=dev), off)
    params = batched.joints.params.clone()
    params[:, 0, 0:3] += off[:, 0, :]
    return pack_envs(batched.replace(
        joints=batched.joints.replace(params=params)))


def check_joint_cg(label, st, cfg):
    """The CG kernel against its plain version on the card, from the same
    system (the one st's next step solves): iterations and stop equal, λ
    within CG_RTOL of its largest magnitude; CUDA-event ms of both, the
    bound from this call's bytes and iterations. Returns a dict and the
    kernel's call (for its device µs, after the timed windows)."""
    rows, w, rhs = joint_system(apply_gravity(st, cfg), cfg)
    lam0 = st.lam_joint
    kw = dict(max_iters=cfg.cg_max_iters, rel_tol=cfg.cg_rel_tol,
              abs_tol=cfg.cg_abs_tol)

    def run(plain=False):
        return cg.solve(rows, w, rhs, lam0, plain=plain, **kw)
    xk, ck, ik = run()
    xp, cp, ip = run(plain=True)
    torch.cuda.synchronize()
    iters = int(ip)
    if int(ik) != iters or bool(ck) != bool(cp):
        raise AssertionError(f"joint CG {label}: kernel {int(ik)} iterations"
                             f" (stop {bool(ck)}), plain {iters} "
                             f"({bool(cp)})")
    err = float((xk - xp).abs().max())
    scale = max(float(xp.abs().max()), 1e-3)
    if not err <= CG_RTOL * scale:
        raise AssertionError(f"joint CG {label}: |Δλ| {err} > "
                             f"{CG_RTOL * scale}")
    kms = median_ms(run, 20)
    pms = median_ms(lambda: run(plain=True), 5)
    nj = rows.j_a.shape[0]
    live = int(rows.rowmask[:, 0].sum())
    # rows, W, rhs and the warm start read once, three int32 a slot (the
    # body ids and flags), λ and the status written once
    nb = nbytes(rows.j_a, rows.j_b, w, rhs, lam0, xk) + 12 * nj + 8
    bnd = bound(nb, (iters + 1) * live * OPS_CG_SLOT)
    plan = cg.plan(nj, st.device)
    log(f"joint CG ({label}): {nj} slots ({live} live), {iters} iterations,"
        f" converged {bool(ck)}; kernel matches plain (iterations and stop "
        f"equal, |Δλ| {err:.3g}, bitwise {torch.equal(xk, xp)}); "
        f"{kms:.4f} ms kernel / {pms:.4f} ms plain (CUDA events), bound "
        f"{bnd[0]:.5f} ms ({bnd[1]}); launch {plan}")
    return {"max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "iters": iters,
            "slots": nj, "launch": plan}, run


def drive_joints(label, make, cfg, steps, gpu):
    """`steps` fresh eager steps with the launch counters set to 0 just
    before and read just after (the CG's: one a step, the others none):
    finite state, CG iterations a step and the stop over the run, ms/step
    over steps 40..steps. Returns (launches, the last state, stats)."""
    zero_counts()
    st = make()
    window0 = min(40, steps // 2)
    its, stops = [], []
    torch.cuda.synchronize()
    for i in range(steps):
        if i == window0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        st, m = step_with_metrics(st, cfg)
        its.append(m["cg_iters"])
        stops.append(m["cg_converged"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    want = {name: steps if name == "joint_cg" else 0 for name in launches}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    for name in ("pos", "quat", "vel", "omega", "lam_joint"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    its = sorted(torch.stack(its).tolist())
    stats = {"iters_min": its[0], "iters_median": its[len(its) // 2],
             "iters_max": its[-1],
             "converged_steps": int(torch.stack(stops).sum())}
    timed = steps - window0
    log(f"{label}: {1e3 * secs / timed:.4f} ms/step eager, "
        f"{st.num_bodies * timed / secs:.1f} body-steps/s over steps "
        f"{window0}..{steps}; CG iterations a step {stats} of {steps}; "
        f"launches {launches}; {gpu}")
    return launches, st, stats


def demo_phase(dev, gpu):
    """The reference's demo scene under compat_config(dt=1/60): the CG
    kernel on its first step, one step against the oracle copy, then 300
    steps (eager) with the largest position and final quaternion error
    against it, and replayed steps against eager ones."""
    dcfg = compat_config(dt=1.0 / 60.0)
    demo = demo_scene(device=dev)
    cg_demo, demo_call = check_joint_cg("demo, first step", demo, dcfg)
    zero_counts()
    ora = oracle.demo_scene()
    st, pos_err, step1 = demo, 0.0, None
    t0 = time.perf_counter()
    for i in range(300):
        st, m = step_with_metrics(st, dcfg)
        ora.update(1.0 / 60.0)
        pos_err = max(pos_err, float((st.pos[0].cpu() - torch.from_numpy(
            ora.bodies[0].position)).abs().max()))
        if i == 0:
            step1 = (pos_err, float((st.quat[0].cpu() - torch.from_numpy(
                ora.bodies[0].rotation)).abs().max()))
    ms = 1e3 * (time.perf_counter() - t0) / 300
    launches = read_counts()
    quat_err = float((st.quat[0].cpu() - torch.from_numpy(
        ora.bodies[0].rotation)).abs().max())
    log(f"demo (compat, dt 1/60): one step against the oracle: pos "
        f"{step1[0]:.3g}, quat {step1[1]:.3g}; 300 steps: max pos error "
        f"{pos_err:.3g}, final quat error {quat_err:.3g} (bounds 1e-3, "
        f"1e-2); x {float(st.pos[0, 0]):.4f} at 5 s; {ms:.4f} ms/step eager"
        f" with a read a step; launches {launches}; {gpu}")
    if launches["joint_cg"] != 300:
        raise AssertionError(f"demo: {launches['joint_cg']} CG launches")
    if not (pos_err < 1e-3 and quat_err < 1e-2):
        raise AssertionError("demo: off the oracle's trajectory")
    checked = replay_agreement("demo", st, dcfg)
    log(f"rollout demo: replayed steps match eager steps (atol {STEP_ATOL}"
        f"): {checked}")
    return launches, cg_demo, demo_call, {
        "pos_err_1": step1[0], "quat_err_1": step1[1],
        "max_pos_err_300": pos_err, "quat_err_300": quat_err}


def guard_phase(dev, gpu, steps=6):
    """The hull motion guard decided on the device, through rollout's
    stepper. Phase 10's octahedra under rain_config's guard (vel_factor
    2; the guard fires on every step there): each replayed GUARDED step
    against an eager step from a copy of the same state. Then 24
    octahedra pressed less (vel_factor 8: steps 1-2 refresh, the guard
    rebuilds at step 3), from one start an eager drive, a second eager
    drive and the stepper, whose replays run under
    torch.cuda.set_sync_debug_mode("error"): launch counts (the guard's
    rebuilds: hull table launches, the stepper's settled after the
    horizon) equal to the eager drive's, the final poses within
    GUARD_POSE_ATOL of it (the second eager drive's distance printed
    beside)."""
    st0, _ = squeezed_rain(octahedron_verts(), 128, dev)
    gcfg = scenes.rain_config(128).replace(contact_rebuild_vel_factor=2.0)
    stepper = DeviceStepper(st0, gcfg)
    seen = collections.Counter()
    step_err = 0.0
    for _ in range(12):
        branch = rebuild_branch(stepper.state, gcfg)
        if branch != GUARDED or branch not in stepper.captured:
            stepper.step()
            continue
        h0 = ht.bucket_hull_contact_table.launches
        ref, _ = step_with_metrics(clone_state(stepper.state), gcfg)
        fired = ht.bucket_hull_contact_table.launches - h0
        stepper.step()
        replay_close(stepper.state, ref,
                     f"guarded replay step {ref.step_count_host - 1}")
        step_err = max(step_err, *(float((getattr(stepper.state, f)
                                          - getattr(ref, f)).abs().max())
                                   for f in ("pos", "quat", "vel", "omega")))
        seen["rebuild" if fired else "refresh"] += 1
    stepper.settle()
    log(f"guarded rain: replayed GUARDED steps match eager steps (atol "
        f"{STEP_ATOL}; largest |Δ| {step_err:.3g}): {dict(seen)}")
    arrays = to_numpy(scenes.hull_rain(octahedron_verts(), 24,
                                       device="cpu"))
    arrays["pos"] *= np.float32([0.7, 0.6, 0.7])
    arrays["pos"][:, 1] += 0.3
    hcfg = scenes.rain_config(24).replace(contact_rebuild_vel_factor=8.0)
    st1 = prepare_contacts(state_from_arrays(arrays, dev), hcfg)
    zero_counts()
    eager = again = st1
    for _ in range(steps):
        eager, _ = step_with_metrics(eager, hcfg)
    want = read_counts()
    for _ in range(steps):
        again, _ = step_with_metrics(again, hcfg)
    zero_counts()
    stepper = DeviceStepper(st1, hcfg)
    warm = 0
    while stepper.captured != {True, GUARDED}:
        stepper.step()
        warm += 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps - warm):
            stepper.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    stepper.settle()
    got = read_counts()
    if got != want:
        raise AssertionError(f"guarded rain: launches {got} != eager {want}")
    scheduled = -(-steps // 4)
    diffs = {}
    for name in ("pos", "quat", "vel", "omega"):
        field = getattr(stepper.state, name)
        d = float((field - getattr(eager, name)).abs().max())
        diffs[name] = (d, float((getattr(again, name)
                                 - getattr(eager, name)).abs().max()))
        if not bool(torch.isfinite(field).all()) or (
                name in ("pos", "quat") and not d <= GUARD_POSE_ATOL):
            raise AssertionError(f"guarded rain: {name} |Δ| {d}")
    guard = want["bucket_hull_contact_table"] - scheduled
    log(f"guarded rain (24 octahedra, vel_factor 8): {steps} steps ({warm} "
        f"warm-up, {steps - warm} replayed under sync debug mode 'error': "
        f"no host read); {want['bucket_hull_contact_table']} rebuilds "
        f"({guard} by the guard) in the eager drive and the replays alike; "
        f"final state |Δ| against the eager drive, and two eager drives' "
        f"spread: {diffs}; launches {got}; {gpu}")
    if guard < 1 or not seen:
        raise AssertionError("guarded rain: the guard never fired")
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settle", type=int, default=60)
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--sharded-steps", type=int, default=48)
    ap.add_argument("--solve-levers", action="store_true",
                    help="also time each solve under each design lever")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = card()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    path, nvcc_s, report = _build.build()
    _build.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {nvcc_s:.1f} s, one process per source)")
    if report:
        log(report.strip())       # ptxas: registers, stack, spills
    for what, n_b, c in (
            ("4k table pile", N_PILE,
             scenes.pile_config(N_PILE).replace(contact_iters=8)),
            ("1,024-hull rain", N_RAIN, scenes.rain_config(N_RAIN)),
            ("packed envs", N_ENVS * ENV_K,
             scenes.packed_env_config(N_ENVS, ENV_K))):
        cp = table_shape(n_b, c)[2]
        log(f"persistent solve 2.3 at the {what}'s {cp} slots: "
            f"{solve_plan(True, cp, dev)}")
    rebuilds = -(-args.steps // 4)

    # ---- phases 3 and 4: the 4k box pile ----
    n = 4096
    cfg = scenes.pile_config(n).replace(contact_iters=8)

    def pile():
        return scenes.box_pile(N_PILE, x_aspect=16.0, device=dev)

    st = prepare_contacts(pile(), cfg)
    for _ in range(args.settle):
        st, m = step_with_metrics(st, cfg)
    torch.cuda.synchronize()
    log(f"pile settled {args.settle} steps: contacts "
        f"{int(m['contact_count'])}")
    results, solves, pile_mode = check_pile_kernels(st, cfg)
    want = {"pile": {"sweep_window_masks": rebuilds,
                     "bucket_contact_table": rebuilds,
                     "banded_sweeps_fused": args.steps}}
    pile_launches, pile_st = drive("pile", pile, cfg, args.steps,
                                   want["pile"], gpu)

    # ---- phase 5: the 1,024-hull rain ----
    n = 1024
    rcfg = scenes.rain_config(n)

    def rain():
        return scenes.mesh_rain(n, real_assets=False, device=dev)

    st = prepare_contacts(rain(), rcfg)
    for _ in range(args.settle):
        st, m = step_with_metrics(st, rcfg)
    torch.cuda.synchronize()
    log(f"rain settled {args.settle} steps: contacts "
        f"{int(m['contact_count'])}")
    (tk, _, wk), geom, _, err, kms, pms, bnd = check_hull_table(
        st, rcfg, "rain 1024")
    results["bucket_hull_contact_table"] = (err, kms, pms, bnd)
    check_candidates("rain", st, rcfg)
    _, rain_solve, rain_solves = check_solve(st, rcfg, tk, wk, geom, "rain")
    solves += rain_solves
    want["rain"] = {"sweep_window_masks": rebuilds,
                    "bucket_hull_contact_table": rebuilds,
                    "banded_sweeps_fused": args.steps}
    rain_launches, rain_st = drive("rain", rain, rcfg, args.steps,
                                   want["rain"], gpu)

    # ---- phase 6: the 3-type hull library, all 9 ordered type pairs ----
    n = 128
    mcfg = scenes.rain_config(n)
    st = prepare_contacts(scenes.mesh_rain_mixed(
        n, n_types=3, real_assets=False, device=dev), mcfg)
    for _ in range(args.settle):
        st, m = step_with_metrics(st, mcfg)
    torch.cuda.synchronize()
    _, _, pairs_sat, err_m, _, _, _ = check_hull_table(
        st, mcfg, "mixed 128 x 3 types")
    seen = sorted(set(pairs_sat.tolist()))
    log(f"mixed: ordered type pairs among the lanes the SAT runs on "
        f"(after the prefilter): {seen}")
    if seen != list(range(9)):
        raise AssertionError(f"mixed: type pairs {seen} != all 9")
    results["bucket_hull_contact_table"] = (
        max(err, err_m),) + results["bucket_hull_contact_table"][1:]

    # ---- phase 7: the two-kernel 4k pile ----
    ncfg = scenes.pile_config(N_PILE).replace(contact_iters=8,
                                              contact_table=False)
    st = prepare_contacts(pile(), ncfg)
    for _ in range(args.settle):
        st, m = step_with_metrics(st, ncfg)
    torch.cuda.synchronize()
    log(f"two-kernel pile settled {args.settle} steps: contacts "
        f"{int(m['contact_count'])}, band_overflow {int(m['band_overflow'])}")
    check_candidates("two-kernel pile", st, ncfg)
    np_results, np_solves = check_np_kernels(st, ncfg)
    results.update(np_results)
    solves += np_solves
    want["two_kernel_pile"] = {
        "sweep_window_masks": args.steps,
        "pair_manifolds_banded": args.steps, "prep_consts": args.steps,
        "banded_sweeps": args.steps}
    np_launches, np_st = drive("two-kernel pile", pile, ncfg, args.steps,
                               want["two_kernel_pile"], gpu)
    # the unfused table solve (2.6 + 2.5 on the table), one warm step
    for fuse in (True, False):
        ucfg = cfg.replace(fuse_prep=False, fuse_integrate=fuse)
        su, _ = step_with_metrics(prepare_contacts(pile_st, ucfg), ucfg,
                                  plain=True)
        steps_match(f"unfused table step (fuse_integrate {fuse})", su, ucfg)

    # ---- phase 8: 4,096 packed envs of 8 boxes ----
    pcfg = scenes.packed_env_config(N_ENVS, ENV_K)

    def packed():
        return scenes.packed_envs(N_ENVS, ENV_K, device=dev)

    st = prepare_contacts(packed(), pcfg)
    for _ in range(args.settle):
        st, m = step_with_metrics(st, pcfg)
    torch.cuda.synchronize()
    nbp = table_shape(st.num_bodies, pcfg)[0]
    log(f"packed envs settled {args.settle} steps: contacts "
        f"{int(m['contact_count'])}; the refresh gate would fire "
        f"{int(refresh_gate(st, pcfg, None).sum())} of {nbp} buckets")
    every = torch.arange(nbp, device=dev)
    modes = check_table_modes("packed", st, pcfg, None, {
        "rebuild": None,
        "refresh, all fired": every >= 0,
        "refresh, 1 in 16 fired": every % 16 == 0,
        "refresh, none fired": every < 0})
    tk, _, wk = modes["rebuild"][5]()
    _, packed_solve, packed_solves = check_solve(
        st, pcfg, tk, wk, unified_geom(st, pcfg, None), "packed")
    solves += packed_solves
    want["packed_envs"] = {"bucket_contact_table": args.steps,
                           "banded_sweeps_fused": args.steps}
    packed_launches, packed_st = drive("packed envs", packed, pcfg,
                                       args.steps, want["packed_envs"], gpu,
                                       zero_overflow=True)

    # ---- phase 9: the gated pile and the sweep's in-kernel broad phase --
    gcfg = cfg.replace(contact_rebuild_vel_factor=2.0)
    st = pile_st
    while st.step_count_host % gcfg.contact_rebuild == 0:
        st, _ = step_with_metrics(st, gcfg)
    gate = refresh_gate(st, gcfg, st.contact_order)
    nbg = gate.shape[0]
    gated = check_table_modes("gated pile", st, gcfg, st.contact_order, {
        "own gate": gate,
        "mixed gate": torch.arange(nbg, device=dev) % 2 == 0})
    steps_match(f"gated pile refresh step {st.step_count_host}", st, gcfg)
    bcfg = cfg.replace(contact_rebuild=1, bp_inkernel=True)
    st = steps_match("sweep bp_k step (cold)", prepare_contacts(pile_st, bcfg),
                     bcfg)
    sweep_bp = check_table_modes("sweep bp_k", st, bcfg,
                                 sweep_order(st, body_aabbs(st)),
                                 {"rebuild": None})
    steps_match("sweep bp_k step (warm)", st, bcfg)
    modes = {"pile, candidates": pile_mode, **modes}
    modes.update({f"gated pile, {k}": v for k, v in gated.items()})
    modes["sweep bp_k, rebuild"] = sweep_bp["rebuild"]
    results["bucket_contact_table"] = (max(
        [results["bucket_contact_table"][0]] + [v[0] for v in modes.values()]),
        ) + results["bucket_contact_table"][1:]

    # ---- phase 10: hull libraries of faces of 3, 6 and 12 vertices ----
    err = check_hull_faces(dev)
    results["bucket_hull_contact_table"] = (max(
        err, results["bucket_hull_contact_table"][0]),) + \
        results["bucket_hull_contact_table"][1:]

    # ---- phase 11: the row-sharded step (no profile: it runs in the ranks)
    # 2.7 at the shapes each sharded path gives it (the pile's row is the
    # one timed), 2.8 in chunked mode on each rank's quarter of the lanes
    sweep, sweep_solves = check_sweep_once(
        "pile", N_PILE, *table_sweep_operands(pile_st, cfg))
    solves += sweep_solves
    np_ops = np_sharded_operands(np_st, ncfg)
    err = max(sweep[0],
              check_sweep_once("rain", N_RAIN,
                               *table_sweep_operands(rain_st, rcfg),
                               timed=False)[0][0],
              check_sweep_once("two-kernel pile", N_PILE, *np_ops,
                               timed=False)[0][0])
    results["banded_sweep_once"] = (err,) + sweep[1:]
    err = max(check_banded_contacts(
        f"2.8 banded contacts (rank {r} of {RANKS}: ground slots, chunked "
        f"lanes)", np_st, ncfg, shard=Shard(None, r, RANKS))[0]
        for r in range(RANKS))
    manifolds = results["pair_manifolds_banded"]
    results["pair_manifolds_banded"] = (max(manifolds[0], err),) + \
        manifolds[1:]
    check_bucket_ranges(pile_st, cfg, False, "2.2 contact table (pile 4096)")
    check_bucket_ranges(rain_st, rcfg, True, "2.4 hull table (rain 1024)")
    sharded_launches = run_sharded(args.sharded_steps, gpu, {
        "sharded_pile": to_numpy(pile_st), "sharded_rain": to_numpy(rain_st),
        "sharded_two_kernel_pile": to_numpy(np_st)})

    # ---- phase 12: the device rollout, replayed from CUDA graphs ----
    rollout_paths = {"pile": (pile, cfg, pile_st),
                     "rain": (rain, rcfg, rain_st),
                     "two_kernel_pile": (pile, ncfg, np_st),
                     "packed_envs": (packed, pcfg, packed_st)}
    rollout_launches, replayers, rollout_ms = {}, {}, {}
    for name, (make, c, end_st) in rollout_paths.items():
        checked = replay_agreement(name, end_st, c)
        log(f"rollout {name}: replayed steps match eager steps from the "
            f"same states (atol {STEP_ATOL}, integer fields identical): "
            f"{checked}")
        rollout_ms[name], rollout_launches[name], replayers[name] = \
            time_rollout(name, make, c, args.steps, want[name], gpu)

    # ---- phase 14: joints and compat; the guard decided on the device
    # (before phase 13's profiles, after every other timed window) ----
    demo_launches, cg_demo, demo_call, demo_err = demo_phase(dev, gpu)
    jcfg = SimConfig(dt=1.0 / 120.0)

    def pendulums():
        return packed_pendulums(N_PEND, dev)

    st = pendulums()
    for _ in range(args.settle):
        st, m = step_with_metrics(st, jcfg)
    cg_envs, envs_call = check_joint_cg(
        f"{N_PEND} packed pendulums after {args.settle} steps", st, jcfg)
    jointed_launches, jointed_st, cg_stats = drive_joints(
        "jointed envs", pendulums, jcfg, args.steps, gpu)
    checked = replay_agreement("jointed envs", jointed_st, jcfg)
    log(f"rollout jointed envs: replayed steps match eager steps from the "
        f"same states (atol {STEP_ATOL}, λ rtol {SOLVE_RTOL}): {checked}")
    want["jointed_envs"] = {"joint_cg": args.steps}
    rollout_ms["jointed_envs"], rollout_launches["jointed_envs"], \
        replayers["jointed_envs"] = time_rollout(
            "jointed_envs", pendulums, jcfg, args.steps,
            want["jointed_envs"], gpu)
    guard_launches = guard_phase(dev, gpu)

    # ---- phase 13: profiles, after every timed window: a finished
    # profiler session can leave the launch path slower ----
    for label, st, c, name in (
            ("pile", pile_st, cfg, "pile"),
            ("rain", rain_st, rcfg, "rain"),
            ("two-kernel pile", np_st, ncfg, "two_kernel_pile"),
            ("packed envs", packed_st, pcfg, "packed_envs"),
            ("jointed envs", jointed_st, jcfg, "jointed_envs")):
        log(f"{label} ({gpu}):")
        profile_steps(EagerStepper(st, c), 8)
        log(f"{label}, replayed from CUDA graphs ({gpu}):")
        profile_steps(replayers[name], 8)
    mode_lines = {}
    for case, (err, kms, pms, (bms, by), fired, call) in modes.items():
        split = kernel_device_split(call, BOX_TABLE)
        us = sum(split.values())
        parts = ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        log(f"2.2 {case}: {us:.1f} us of device a launch ({parts}; {fired} "
            f"buckets fired; {gpu})")
        mode_lines[case] = {"max_abs_err": err, "ms": kms, "plain_ms": pms,
                            "bound_ms": bms, "bound_by": by,
                            "device_us": us, "fired_buckets": fired}
    # a solve call's device time: all of its kernel's work, barriers
    # included (one launch a call for 2.3 and 2.5, one for 2.7)
    solve_us = {}
    for name, label, call, kms, (bms, by), live in solves:
        names = ("sharded_sweep_kernel",) if name == "banded_sweep_once" \
            else ("solve_kernel",)
        us = kernel_device_us(call, names)
        solve_us.setdefault(name, {})[label] = us
        log(f"{name} ({label}): {us:.1f} us of device a launch, "
            f"{kms:.4f} ms by CUDA events, bound {bms:.5f} ms ({by}), "
            f"{live} live contacts ({gpu})")
    # the device operations a call puts on the card: 2.1's pair_candidates
    # at each path's shapes, a 2.7 sweep
    for label, call in CANDIDATE_CALLS.items():
        n_ops, us, parts = device_ops(call)
        log(f"2.1 pair_candidates ({label}): {n_ops:g} device operations, "
            f"{us:.1f} us of device a call ({parts}; {gpu})")
    for s in solves:
        if s.name == "banded_sweep_once":
            n_ops, us, parts = device_ops(s.call)
            log(f"2.7 ({s.label}): {n_ops:g} device operations, {us:.1f} "
                f"us of device a call ({parts}; {gpu})")
    if args.solve_levers:
        solve_levers(solves, gpu)
    cg_us = {}
    for label, call, info in (("demo", demo_call, cg_demo),
                              ("jointed_envs", envs_call, cg_envs)):
        cg_us[label] = kernel_device_us(call, ("cg_kernel",))
        log(f"joint_cg ({label}): {cg_us[label]:.1f} us of device a launch "
            f"({info['iters']} iterations), {info['ms']:.4f} ms by CUDA "
            f"events, bound {info['bound_ms']:.5f} ms ({info['bound_by']}); "
            f"{gpu}")

    sources = {
        "sweep_window_masks": ("cuda", "physics_tpu_torch/csrc/sweep.cu",
                               "physics_tpu/ops/sweep_pallas.py:91"),
        "bucket_contact_table": ("cuda", "physics_tpu_torch/csrc/contact_table.cu",
                                 "physics_tpu/ops/contact_table.py:1032"),
        "bucket_hull_contact_table": ("cuda", "physics_tpu_torch/csrc/hull_table.cu",
                                      "physics_tpu/ops/hull_table.py:1218"),
        "banded_sweeps_fused": ("cuda", "physics_tpu_torch/csrc/banded_solve.cu",
                                "physics_tpu/solver/contacts_pallas.py:861"),
        "banded_sweeps": ("cuda", "physics_tpu_torch/csrc/banded_solve.cu",
                          "physics_tpu/solver/contacts_pallas.py:723"),
        "prep_consts": ("cuda", "physics_tpu_torch/csrc/banded_solve.cu",
                        "physics_tpu/solver/contacts_pallas.py:1241"),
        "pair_manifolds_banded": ("cuda",
                                  "physics_tpu_torch/csrc/narrowphase_banded.cu",
                                  "physics_tpu/ops/narrowphase_pallas.py:232"),
        "banded_sweep_once": ("cuda", "physics_tpu_torch/csrc/banded_solve.cu",
                              "physics_tpu/solver/contacts_pallas.py:1001"),
        "joint_cg": ("cuda", "physics_tpu_torch/csrc/joint_cg.cu",
                     "physics_tpu/solver/cg.py:79 (lax.while_loop; no "
                     "Pallas kernel)"),
    }
    results["joint_cg"] = (
        max(cg_demo["max_abs_err"], cg_envs["max_abs_err"]), cg_envs["ms"],
        cg_envs["plain_ms"], (cg_envs["bound_ms"], cg_envs["bound_by"]))
    kernels = []
    for name, (route, src, rep) in sources.items():
        err, kms, pms, (bms, by) = results[name]
        by_path = {"pile": pile_launches[name], "rain": rain_launches[name],
                   "two_kernel_pile": np_launches[name],
                   "packed_envs": packed_launches[name],
                   "demo": demo_launches[name],
                   "jointed_envs": jointed_launches[name],
                   "guarded_rain_rollout": guard_launches[name],
                   **{path: counts[name]
                      for path, counts in sharded_launches.items()},
                   **{f"rollout_{path}": counts[name]
                      for path, counts in rollout_launches.items()}}
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": rep,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": err, "ms": kms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by,
                        # no single PyTorch call computes any of these
                        "library_ms": None})
        if name == "bucket_contact_table":
            kernels[-1]["modes"] = mode_lines
        if name == "prep_consts":
            # no launch of its own: sweep 0 of 2.5 and of 2.7 computes it
            # (ms: the 2.5 launch it runs in; max_abs_err: its bit-for-bit
            # check; launches: one a solve)
            kernels[-1]["folded_into"] = ["banded_sweeps",
                                          "banded_sweep_once"]
        if name in solve_us:
            kernels[-1]["device_us"] = solve_us[name]
        if name == "joint_cg":
            # ms, plain_ms, bound: the packed pendulums' call; each size's
            # own in `sizes`
            kernels[-1].update(device_us=cg_us, sizes={
                "demo": cg_demo, "jointed_envs": cg_envs},
                iters_a_step=cg_stats, demo_trajectory=demo_err)
    log(f"rollout ms/step (host clock, steps 40..{args.steps}; {gpu}): "
        f"{json.dumps(rollout_ms)}")
    log(f"rain solve: {json.dumps(rain_solve)}")
    log(f"packed solve: {json.dumps(packed_solve)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
