"""The port's kernels against their plain PyTorch versions on an NVIDIA
card, and one rebuild and one refresh step of the kernel path against the
plain path, on a contact-rich two-bucket pile and on hull rains (the
hull contact table: two buckets of bevelled cubes, one bucket of the
3-type library with all 9 ordered type pairs in one SAT block, and one
bucket of axis-aligned duplicated hulls whose face and edge separations
tie; its warm match with duplicated previous keys); on the same pile, the
two-kernel path's contact list (ground corners and pair manifolds in one
launch, whole and one rank's slice), unfused sweeps (2.5, with the solve
constants, 2.6, built in their sweep 0: bit for bit prep_consts_plain),
two of its steps, and a step of the unfused table solve; the row-sharded
step's single-sweep kernel (2.7) in each of its switch combinations (its
sweep 0's constants bit for bit, on a whole table and on one rank's
columns of it) and its whole loop on one rank, and the table kernels'
bucket-range mode. The
sweep kernel (2.1) in both modes: the masks, and the bucketed candidates
at the pile's, the rain's and the two-kernel pile's bucket shapes and at
the compaction's edges; a 2.1 call and a 2.7 sweep captured in a CUDA
graph and replayed. The box table's other modes: the
in-kernel broad phase on the sweep order, the per-bucket gate (fired and
passed-through buckets in one launch) and packed envs at the packed
configuration's bucket shapes (896 lanes, 8 picks, 768 slots), with a
rebuild and a gated refresh step of the packed path, the gated pile and
the hull rain's motion guard; saturated buckets (contacts beyond ccap,
lanes beyond the prefilter's or the in-kernel broad phase's cap),
duplicated previous keys, a call captured in a CUDA graph (candidates,
gated) and 2,048 lanes of 8 picks a bucket. The geometry table
(csrc/geom_table.cu) bit for bit against its plain version, as int32
views: the 4k pile, 8,008 packed bodies in the identity order, turned and
static bodies, hull mode, the generic banded path's width, and a call
captured in a CUDA graph and replayed on new poses;
and the hull table on libraries whose largest face has 3, 5, 6, 8, 12,
20 or 63 vertices (the last two above what the manifold kernel holds in
registers). The persistent solves (2.3 and 2.5, one cooperative launch
a call) also on the rain's and the packed envs' tables and on synthetic
tables: no live contact, every slot live with more live contacts a block
than its shared memory holds, one sweep, NPAD not a multiple of the
block; and one 2.3 call captured in a CUDA graph and replayed. The
device rollout (engine.DeviceStepper, one captured graph a branch of the
step) on the table pile, the hull rain, the two-kernel pile and the
packed envs, and on the jointed paths (the reference's demo scene under
compat_config, packed pendulums): each replayed step against an eager
step from the same state, across a rebuild boundary, a branch's warm-up
step and capture each counting an eager step's launches and a replay
none; the hull motion guard decided on
the device inside one graph (conditional nodes): replayed guard steps
against eager ones, and a horizon under
torch.cuda.set_sync_debug_mode("error") with the eager drive's rebuilds;
a sampled horizon; and a capture that fails raises. The generic hull
path (rain_xla_config, 256 bevelled cubes and 128 of the 3-type
library): its contact list with 2.1's masks mode and the pair contacts'
kernel (csrc/hull_list.cu) against the plain list, two steps of the
kernel path against the plain path, the TF32 refusal of the plain
version's support products (the kernel path takes none), replayed steps
against eager ones (on both libraries) and replays under
set_sync_debug_mode("error"). The joint CG kernel
(csrc/joint_cg.cu) against its plain version at the demo's size, at the
4,096 packed pendulums' and at a few more than one slot a thread
holds.
Every test skips without a card. On a GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which neither the port
nor this file needs.)

Tolerances: the sweep masks and candidates, the contact table's integer rows, its meta
counters and warm rows are compared exactly (the table kernel computes the
plain version's f32 operations in the same order, built with
-fmad=false); its f32 rows to 1e-5 of the scene extent, as the contact
list's f32 fields (whose ids, keys, activity and rank rows are exact). The solve constants
(2.6, built in the sweep 0 of 2.5 and 2.7) have no sums across contacts:
bit for bit on the touched slots. The solves sum impulse deltas with
atomics (kernel) or
index_add (plain) in an order that changes from run to run: 1e-4 of each
output row's largest magnitude. The joint CG sums its dot products in
one fixed order in both versions and each pendulum body gets at most two
joints' atomic adds (whose sum has one value in either order): its
iterations and stop equal, its result within 1e-5 of the largest |λ|.
"""

import dataclasses

import numpy as np
import pytest
import torch

from physics_tpu_torch import scenes
from physics_tpu_torch.config import SimConfig, compat_config
from physics_tpu_torch.engine import (
    DeviceStepper,
    capture_graph,
    joint_system,
    prepare_contacts,
    rollout,
    step,
    step_with_metrics,
)
from physics_tpu_torch.ops.forces import apply_gravity
from physics_tpu_torch.ops.integrator import gravity_and_velocities
from physics_tpu_torch.scene import demo_scene
from physics_tpu_torch.solver import cg
from physics_tpu_torch.io.primitives import octahedron_verts, prism_verts
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops import hull_table as tht
from physics_tpu_torch.ops.broadphase import (
    body_aabbs,
    pair_candidates,
    sweep_order,
)
from physics_tpu_torch.ops.hull_list import hull_pair_contacts
from physics_tpu_torch.ops.narrowphase import banded_contacts, hull_segments
from physics_tpu_torch.ops.narrowphase_banded import body_table_width
from physics_tpu_torch.ops.sweep_kernel import (
    bucketed_candidates,
    sweep_window_masks,
)
from physics_tpu_torch.solver.banded_solve import (
    banded_operands,
    banded_sweep_once,
    banded_sweeps,
    banded_sweeps_fused,
    banded_sweeps_plain,
    banded_z0,
    prep_consts_plain,
    prep_kw,
    rows_of,
    solve_plan,
    sweep_result,
    sweep_scratch,
    table_solve_operands,
)
from physics_tpu_torch.parallel.collectives import Shard
from physics_tpu_torch.solver.contacts import (
    GUARDED,
    banded_contact_list,
    banded_inputs,
    hull_contact_list,
    rebuild_branch,
)
from physics_tpu_torch.state import SHAPE_NONE, state_from_arrays, to_numpy

from test_torch_geom_table import flipped, statics
from test_torch_pendulums import packed_pendulums

pytestmark = pytest.mark.cuda

N = 192
EXACT_ROWS = [tct.CT_ACT, tct.CT_KL, tct.CT_KH, tct.CT_KSGN, tct.CT_RA,
              tct.CT_RB1, tct.CT_KS, tct.CT_MU, tct.CT_REST]
SOLVE_RTOL = 1e-4
# the two-kernel pile at test sizes (tests/test_torch_pair_manifolds.py)
NP_KW = dict(contact_table=False, contact_rebuild=1, bucket_block=8,
             bucket_cap=128, pallas_tile=128, pallas_window=256)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def pile(dev):
    """A box pile squeezed so neighbouring boxes interpenetrate, with
    random velocities; prepared for the anchored table path."""
    arrays = to_numpy(scenes.box_pile(N, x_aspect=4.0, layers=3))
    rng = np.random.default_rng(1)
    arrays["pos"][:, 0] *= 0.85
    arrays["pos"][:, 1] *= 0.85
    arrays["vel"] = rng.normal(0, 0.5, (N, 3)).astype(np.float32)
    arrays["omega"] = rng.normal(0, 0.5, (N, 3)).astype(np.float32)
    cfg = scenes.pile_config(N).replace(contact_iters=8)
    return prepare_contacts(state_from_arrays(arrays, dev), cfg), cfg


def _rows_close(name, got, ref, rtol):
    for r in range(ref.shape[0]):
        tol = rtol * max(float(ref[r].abs().max()), 1e-3)
        err = float((got[r] - ref[r]).abs().max())
        assert err <= tol, f"{name} row {r}: |Δ| {err} > {tol}"


@pytest.mark.parametrize("k", [1, 12, 48])
def test_sweep_masks_kernel(pile, k):
    """2.1's masks mode, bit for bit."""
    s, _ = pile
    aabbs = body_aabbs(s)
    oi = sweep_order(s, aabbs).long()
    aabb_s = aabbs[oi].contiguous()
    coll_s = (s.shapes.stype != SHAPE_NONE)[oi].contiguous()
    before = sweep_window_masks.launches
    mk, lk = sweep_window_masks(aabb_s, coll_s, k)
    assert sweep_window_masks.launches == before + 1
    mp, lp = sweep_window_masks(aabb_s, coll_s, k, plain=True)
    assert torch.equal(mk, mp) and torch.equal(lk, lp)
    assert int(mk.sum()) > 0


# 2.1's candidates mode: config overrides and a non-collidable tail at the
# shapes of the 4k pile (window 48, buckets of 128: 192 bodies are 1.5 of
# them), the rain (window 32, 1,536 lanes), the two-kernel pile's test
# size, and the edges of tests/test_torch_sweep_candidates.py
CAND_CASES = {
    "pile": ({}, 0),
    "rain": ({"sweep_window": 32, "bucket_cap": 1536}, 0),
    "two_kernel": ({"bucket_block": 8, "bucket_cap": 128}, 0),
    "block_k_below_cap": ({"bucket_block": 8, "sweep_window": 6,
                           "bucket_cap": 128}, 0),
    "saturated_bucket": ({"bucket_cap": 128}, 0),
    "window_edge": ({"sweep_window": 3}, 0),
    "non_collidable_tail": ({}, 40),
}


def _candidates(s, cfg, plain):
    aabbs = body_aabbs(s)
    return pair_candidates(s, cfg, aabbs, sweep_order(s, aabbs), plain=plain)


@pytest.mark.parametrize("case", list(CAND_CASES))
def test_bucketed_candidates_kernel(pile, case):
    """2.1's candidates mode (one launch from the order to every field)
    against its plain version, bit for bit, dead lanes and overflow
    included."""
    s, cfg = pile
    overrides, tail = CAND_CASES[case]
    cfg = cfg.replace(**overrides)
    if tail:
        stype = s.shapes.stype.clone()
        stype[-tail:] = SHAPE_NONE
        s = s.replace(shapes=s.shapes.replace(stype=stype))
    before = bucketed_candidates.launches
    ck = _candidates(s, cfg, False)
    assert bucketed_candidates.launches == before + 1
    cp = _candidates(s, cfg, True)
    for name, a, b in zip(ck._fields, ck, cp):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(ck.mask.sum()) > 50
    if case == "saturated_bucket":
        hits = ck.mask.reshape(-1, 128).sum(dim=1)
        assert int(ck.overflow) > 0 and int(hits.max()) == 128


def _table(s, cfg, prev, plain):
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    cand = pair_candidates(s, cfg, aabbs, order, plain=plain)
    geom = tct.unified_geom(s, cfg, order)
    return geom, tct.bucket_contact_table(s, cand, cfg, prev=prev,
                                          geom=geom, plain=plain)


def test_contact_table_kernel(pile):
    s, cfg = pile
    # previous keys from a first table, impulses random: warm rows match
    _, (t0, _, _) = _table(s, cfg, None, plain=True)
    keys = tct.table_keys(t0)
    lam = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (3, keys.shape[1])).astype(np.float32)).to(s.device)
    before = tct.bucket_contact_table.launches
    geom, (tk, mk, wk) = _table(s, cfg, (keys, lam), plain=False)
    assert tct.bucket_contact_table.launches == before + 1
    _, (tp, mp, wp) = _table(s, cfg, (keys, lam), plain=True)
    for r in EXACT_ROWS:
        assert torch.equal(tk[r], tp[r]), r
    assert torch.equal(mk, mp)
    assert torch.equal(wk, wp)
    extent = float(geom[0:3, :N].abs().max())
    assert float((tk - tp).abs().max()) <= 1e-5 * extent
    assert int(tk[tct.CT_ACT].sum()) > 500
    assert float(wk[0].abs().sum()) > 0


@pytest.mark.parametrize("iters", [8, 4])
def test_banded_solve_kernel(pile, iters):
    s, cfg = pile
    geom, (table, _, warm) = _table(
        s, cfg, (s.contact_key, s.contact_lam), plain=True)
    warm = warm.clone()
    warm[0:3] = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 0.1, (3, warm.shape[1])).astype(np.float32)).to(s.device)
    out = {}
    for plain in (False, True):
        out[plain] = banded_sweeps_fused(
            table, warm, geom, cfg, vel_iters=iters, pos_iters=iters,
            use_split=True, integrate=(cfg.dt, True), plain=plain)
    (zk, lk, pk), (zp, lp, pp) = out[False], out[True]
    _rows_close("z", zk[:, :N], zp[:, :N], SOLVE_RTOL)
    _rows_close("lam", lk, lp, SOLVE_RTOL)
    _rows_close("posq", pk[:, :N], pp[:, :N], SOLVE_RTOL)


def _solves_match(table, warm, geom, cfg, iters, pos_iters=None,
                  integrate=True):
    """2.3 against its plain version; one launch a call."""
    pos_iters = iters if pos_iters is None else pos_iters
    out = {}
    for plain in (False, True):
        before = banded_sweeps_fused.launches
        out[plain] = banded_sweeps_fused(
            table, warm, geom, cfg, vel_iters=iters, pos_iters=pos_iters,
            use_split=pos_iters > 0,
            integrate=(cfg.dt, True) if integrate else None, plain=plain)
        assert banded_sweeps_fused.launches == before + (not plain)
    (zk, lk, pk), (zp, lp, pp) = out[False], out[True]
    n = geom.shape[1]
    _rows_close("z", zk[:, :n], zp[:, :n], SOLVE_RTOL)
    _rows_close("lam", lk, lp, SOLVE_RTOL)
    if integrate:
        _rows_close("posq", pk, pp, SOLVE_RTOL)
    return zk, lk


@pytest.mark.parametrize("shape", ["rain", "packed"])
def test_banded_solve_kernel_shapes(dev, shape):
    """2.3 on the anchored refresh of the rain's and the packed envs'
    persisted tables (a bucket of 256 bevelled cubes; 32 packed envs, two
    buckets of 768 slots), warm, both schedules."""
    if shape == "rain":
        s = scenes.mesh_rain(256, real_assets=False, device=dev)
        cfg = scenes.rain_config(256)
    else:
        s = scenes.packed_envs(32, 8, device=dev)
        cfg = scenes.packed_env_config(32, 8)
    s = prepare_contacts(s, cfg)
    for _ in range(3):
        s, _ = step_with_metrics(s, cfg, plain=True)
    geom = tct.unified_geom(s, cfg, s.contact_order, hulls=cfg.hull_table)
    cp = s.contact_table.shape[1]
    warm = torch.cat([s.contact_lam, torch.zeros((5, cp), device=dev)])
    assert int(s.contact_table[tct.CT_ACT].sum()) > 50
    for iters in (8, 4):
        _solves_match(s.contact_table, warm, geom, cfg, iters)


def _synthetic(dev, n, tile, ntiles, live_every=1, seed=0):
    """A random solve over n bodies (NPAD = n) and tile·ntiles contact
    slots, every `live_every`-th slot active: the fused solve's table
    [16, Cp] (not anchored) and geometry [48, n], and the unfused
    solve's window operands (bases, la, lb) and constants of the same
    contacts."""
    rng = np.random.default_rng(seed)
    cp = tile * ntiles
    geom = np.zeros((48, n), np.float32)
    geom[0:3] = rng.uniform(-20, 20, (3, n))
    for k in range(3):
        geom[3 + 4 * k] = rng.uniform(0.5, 2.0, n)   # world inverse inertia
    geom[12] = rng.uniform(0.5, 2.0, n)             # inverse mass
    geom[13:19] = rng.normal(0, 0.3, (6, n))        # v, ω
    geom[19] = 1.0                                  # quat (w, x, y, z)
    win = 256
    bases = np.minimum(np.arange(ntiles) * 128, n - win).astype(np.int32)
    la = rng.integers(0, win, cp).astype(np.int32)
    lb = rng.integers(-1, win, cp).astype(np.int32)
    lb = np.where(lb == la, -1, lb)
    act = (np.arange(cp) % live_every) == 0
    la, lb = np.where(act, la, -1), np.where(act, lb, -1)
    base = np.repeat(bases, tile)
    nrm = rng.normal(0, 1, (3, cp))
    nrm /= np.linalg.norm(nrm, axis=0)
    table = np.zeros((16, cp), np.float32)
    table[0:3] = geom[0:3, np.maximum(base + la, 0)] + rng.normal(
        0, 0.3, (3, cp))
    table[3:6] = nrm
    table[6] = rng.uniform(0.0, 0.05, cp)
    table[7] = 0.5
    table[9] = act
    table[13] = np.where(act, base + la, 0)
    table[14] = np.where(lb >= 0, base + lb + 1, 0)
    warm = np.zeros((8, cp), np.float32)
    warm[0] = rng.uniform(0.0, 0.2, cp) * act
    warm[1:3] = rng.uniform(-0.02, 0.02, (2, cp)) * act
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    cin = np.concatenate([table[0:10], warm[0:3], (lb >= 0)[None]]).astype(
        np.float32)
    return t(table), t(warm), t(geom), t(bases), t(la), t(lb), t(cin)


@pytest.mark.parametrize("case", ["no_live", "all_live", "one_sweep",
                                  "odd_npad"])
def test_persistent_solves_edge_cases(dev, case):
    """2.3 and 2.5 on synthetic solves. all_live: 196,608 slots, every
    one live, more live contacts a block than the block's shared memory
    holds (the rest are read from global memory); no_live: every slot
    inactive; one_sweep: no velocity or position sweep; odd_npad: 1,000
    bodies, not a multiple of the block."""
    cfg = scenes.pile_config(1000).replace(contact_rebuild=1)
    n, tile, ntiles, every = {"no_live": (1000, 128, 8, 10 ** 9),
                              "all_live": (33024, 768, 256, 1),
                              "one_sweep": (4352, 1024, 24, 3),
                              "odd_npad": (1000, 128, 8, 2)}[case]
    table, warm, geom, bases, la, lb, cin = _synthetic(dev, n, tile, ntiles,
                                                       every)
    if case == "no_live":
        table[tct.CT_ACT] = 0.0
    iters = 0 if case == "one_sweep" else 8
    if case == "all_live":
        plan = solve_plan(True, table.shape[1], dev)
        assert plan["held_a_block"] < plan["slots_a_block"]
    zk, lk = _solves_match(table, warm, geom, cfg, iters)
    if case == "no_live":
        assert not lk.any() and torch.equal(zk[0:6], geom[13:19])
    z0 = banded_z0(geom)
    posq = torch.cat([geom[0:3], geom[19:23], torch.zeros_like(geom[0:1])])
    out = {}
    for plain in (False, True):
        out[plain] = banded_sweeps(z0, bases, la, lb, geom, cin, tile=tile,
                                   vel_iters=iters, pos_iters=iters,
                                   posq=posq, integrate=(cfg.dt, True),
                                   plain=plain, **prep_kw(cfg, True))
    (zk, lk, pk), (zp, lp, pp) = out[False], out[True]
    _rows_close("z", zk, zp, SOLVE_RTOL)
    _rows_close("lam", lk, lp, SOLVE_RTOL)
    _rows_close("posq", pk, pp, SOLVE_RTOL)


def test_banded_solve_kernel_graph_replay(pile):
    """One 2.3 call captured in a CUDA graph and replayed, against the
    eager call."""
    s, cfg = pile
    geom, (table, _, warm) = _table(
        s, cfg, (s.contact_key, s.contact_lam), plain=True)

    def call():
        return banded_sweeps_fused(table, warm, geom, cfg, vel_iters=8,
                                   pos_iters=8, use_split=True,
                                   integrate=(cfg.dt, True))
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(("z", "lam", "posq"), captured, eager):
        _rows_close(name, a, b, SOLVE_RTOL)


def _steps_match(s, cfg):
    """Two steps (on the anchored paths a rebuild and a refresh), each
    from the kernel path's state."""
    for what in ("first", "second"):
        sk, mk = step_with_metrics(s, cfg)
        sp, mp = step_with_metrics(s, cfg, plain=True)
        for name in ("pos", "quat", "vel", "omega"):
            err = float((getattr(sk, name) - getattr(sp, name)).abs().max())
            assert err <= 1e-4, (what, name, err)
        assert torch.equal(sk.contact_key, sp.contact_key), what
        for key in ("contact_count", "pair_overflow", "contact_overflow"):
            assert int(mk[key]) == int(mp[key]), (what, key)
        s = sk


def test_step_kernel_path_matches_plain(pile):
    _steps_match(*pile)


@pytest.fixture(scope="module", params=[(256, 1), (128, 3)],
                ids=["rain256", "mixed128x3"])
def rain(dev, request):
    """A hull rain (two full buckets of bevelled cubes, or one bucket of
    the 3-type library) prepared for rain_config and stepped twice along
    the plain path, so the warm keys are live."""
    n, types = request.param
    if types == 1:
        s = scenes.mesh_rain(n, real_assets=False, device=dev)
    else:
        s = scenes.mesh_rain_mixed(n, n_types=types, real_assets=False,
                                   device=dev)
    cfg = scenes.rain_config(n)
    s = prepare_contacts(s, cfg)
    for _ in range(2):
        s, _ = step_with_metrics(s, cfg, plain=True)
    return s, cfg


def _hull_table(s, cfg, kernel):
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    cand = pair_candidates(s, cfg, aabbs, order, plain=True)
    geom = tct.unified_geom(s, cfg, order, hulls=True)
    return geom, tht.bucket_hull_contact_table(
        s, cand, cfg, prev=(s.contact_key, s.contact_lam), geom=geom,
        plain=not kernel)


def test_hull_table_kernel(rain):
    s, cfg = rain
    before = tht.bucket_hull_contact_table.launches
    geom, (tk, mk, wk) = _hull_table(s, cfg, kernel=True)
    assert tht.bucket_hull_contact_table.launches == before + 1
    _, (tp, mp, wp) = _hull_table(s, cfg, kernel=False)
    for r in EXACT_ROWS:
        assert torch.equal(tk[r], tp[r]), r
    assert torch.equal(mk, mp)
    assert torch.equal(wk, wp)
    extent = float(geom[0:3, :s.num_bodies].abs().max())
    assert float((tk - tp).abs().max()) <= 1e-5 * extent
    assert int(tk[tct.CT_ACT].sum()) > 100
    assert int((tk[tct.CT_ACT] * (1 - tk[tct.CT_KSGN])).sum()) > 20


def test_rain_step_kernel_path_matches_plain(rain):
    _steps_match(*rain)


@pytest.fixture(scope="module", params=[(256, 1), (128, 3)],
                ids=["rain256", "mixed128x3"])
def xla_rain(dev, request):
    """A hull rain under rain_xla_config (the generic hull path: the
    flat sweep through 2.1's masks mode, the OBB prefilter, the hull
    fast contacts, 2.5 with 2.6 in its sweep 0), stepped twice along the
    plain path."""
    n, types = request.param
    if types == 1:
        s = scenes.mesh_rain(n, real_assets=False, device=dev)
    else:
        s = scenes.mesh_rain_mixed(n, n_types=types, real_assets=False,
                                   device=dev)
    cfg = scenes.rain_xla_config(n)
    s = prepare_contacts(s, cfg)
    for _ in range(2):
        s, _ = step_with_metrics(s, cfg, plain=True)
    return s, cfg


def test_xla_rain_contact_list_kernel_path_matches_plain(xla_rain):
    """The contact list with 2.1's masks mode and the pair contacts'
    kernel (csrc/hull_list.cu) against its plain version: candidates,
    prefilter, keys, ranks and counters identical, f32 fields within 1e-5
    of the scene extent; one masks launch a list, two pair-contact
    launches a type-pair segment."""
    s, cfg = xla_rain
    before = sweep_window_masks.launches
    pairs = hull_pair_contacts.launches
    got = hull_contact_list(s, cfg)
    assert sweep_window_masks.launches == before + 1
    assert hull_pair_contacts.launches == pairs + 2 * len(
        hull_segments(s, got.cand))
    ref = hull_contact_list(s, cfg, plain=True)
    assert hull_pair_contacts.launches == pairs + 2 * len(
        hull_segments(s, got.cand))
    (ck, (lok, rbk), _, gk, candk, cp, ovk) = got
    (cpl, (lop, rbp), _, gp, candp, cpp, ovp) = ref
    assert cp == cpp and torch.equal(gk, gp)
    for f in candk._fields:
        assert torch.equal(getattr(candk, f), getattr(candp, f)), f
    assert ovk.keys() == ovp.keys() == {"pair_overflow", "prefilter_overflow"}
    assert all(int(ovk[k]) == int(ovp[k]) for k in ovk)
    assert torch.equal(lok, lop) and torch.equal(rbk, rbp)
    for f in ("body_a", "body_b", "key", "active"):
        assert torch.equal(getattr(ck, f), getattr(cpl, f)), f
    extent = float(s.pos.abs().max())
    for f in ("point", "normal", "depth", "friction", "restitution"):
        assert float((getattr(ck, f) - getattr(cpl, f)).abs().max()) <= \
            1e-5 * extent, f
    assert int(ck.active.sum()) > 50


def test_xla_rain_step_kernel_path_matches_plain(xla_rain):
    s, cfg = xla_rain
    m0, b0 = sweep_window_masks.launches, banded_sweeps.launches
    step_with_metrics(s, cfg)
    assert sweep_window_masks.launches == m0 + 1
    assert banded_sweeps.launches == b0 + 1
    _steps_match(s, cfg)


def test_xla_rain_refuses_tf32_supports(xla_rain):
    """The plain version's hull SAT support products refuse TF32 matmuls
    on the card rather than decide contacts from 10-bit mantissas; the
    kernel path takes no matmul, so TF32 leaves its step as it is."""
    s, cfg = xla_rain
    want, _ = step_with_metrics(s, cfg)
    prev = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        with pytest.raises(RuntimeError, match="full-f32"):
            step_with_metrics(s, cfg, plain=True)
        got, _ = step_with_metrics(s, cfg)
    finally:
        torch.backends.cuda.matmul.fp32_precision = prev
    assert torch.equal(got.contact_key, want.contact_key)
    assert float((got.pos - want.pos).abs().max()) <= 1e-4


def test_hull_table_sat_block_holds_several_type_pairs(dev):
    """The 3-type library's first SAT block (128 lanes) holds lanes of
    several ordered type pairs, each pass masked to its own lanes."""
    n = 128
    cfg = scenes.rain_config(n)
    s = prepare_contacts(scenes.mesh_rain_mixed(n, n_types=3,
                                                real_assets=False,
                                                device=dev), cfg)
    for _ in range(2):
        s, _ = step_with_metrics(s, cfg, plain=True)
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    cand = pair_candidates(s, cfg, aabbs, order, plain=True)
    geom = tct.unified_geom(s, cfg, order, hulls=True)
    la, lb, _, kw = tct.table_operands(s, cand, cfg, None, geom, "lanes")
    ga, gb = tct.lane_geometry(geom, la), tct.lane_geometry(geom, lb)
    la, lb, _ = tct.obb_prefilter(ga, gb, la, lb, kw["cap2"], True)
    ga, gb = tct.lane_geometry(geom, la), tct.lane_geometry(geom, lb)
    live = (la >= 0)[0, :128]
    pairs = ((ga[19] - 1) * 3 + gb[19] - 1)[0, :128][live]
    assert torch.unique(pairs).numel() >= 3
    _hull_tables_match(s, cfg)


def _hull_tables_match(s, cfg, prev=None):
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    cand = pair_candidates(s, cfg, aabbs, order, plain=True)
    geom = tct.unified_geom(s, cfg, order, hulls=True)
    prev = prev if prev is not None else (s.contact_key, s.contact_lam)
    out = [tht.bucket_hull_contact_table(s, cand, cfg, prev=prev, geom=geom,
                                         plain=plain) for plain in (False, True)]
    (tk, mk, wk), (tp, mp, wp) = out
    for r in EXACT_ROWS:
        assert torch.equal(tk[r], tp[r]), r
    assert torch.equal(mk, mp) and torch.equal(wk, wp)
    extent = float(geom[0:3, :s.num_bodies].abs().max())
    assert float((tk - tp).abs().max()) <= 1e-5 * extent
    return tk, wk


def test_hull_table_kernel_tied_separations(dev):
    """Duplicated hulls in pairs at mirrored poses (axis-aligned, or turned
    by 90° or 180° about y, overlapping along x), resting on the ground:
    their face separations tie between A's and B's faces and their edge
    axes tie among parallel edges, so every choice rests on the first-index
    rule; the kernel's split reductions must make the plain version's."""
    n = 128
    cfg = scenes.rain_config(n)
    s = scenes.mesh_rain(n, real_assets=False, device=dev)
    verts = s.hulls.verts[0][:int(s.hulls.vert_count[0])]
    h = float(verts.abs().max())
    i = torch.arange(n, device=dev)
    pair, side = i // 2, i % 2
    pos = torch.stack([(4 * h) * (pair % 8) + side * (2 * h - 0.02),
                       torch.full_like(i, 1, dtype=torch.float32) * (h - 0.01),
                       (4 * h) * (pair // 8)], dim=1).float()
    turn = (pair % 3).float() * (torch.pi / 4) * side   # 0°, 90°, 180° about y
    quat = torch.stack([torch.cos(turn), torch.zeros_like(turn),
                        torch.sin(turn), torch.zeros_like(turn)], dim=1)
    s = s.replace(pos=pos.contiguous(), quat=quat.contiguous(),
                  vel=torch.zeros_like(s.vel), omega=torch.zeros_like(s.omega))
    s = prepare_contacts(s, cfg)
    s, _ = step_with_metrics(s, cfg, plain=True)
    tk, _ = _hull_tables_match(s, cfg)
    assert int((tk[tct.CT_ACT] * (1 - tk[tct.CT_KSGN])).sum()) > 50


def test_hull_table_warm_match_first_of_duplicate_keys(rain):
    """Previous keys with duplicates in one bucket: the first previous
    slot (index order) with the key gives the warm λ, as in the plain
    version's first match."""
    s, cfg = rain
    keys, lam = s.contact_key.clone(), s.contact_lam.clone()
    ccap = tct.table_shape(s.num_bodies, cfg)[1]
    live = torch.nonzero(keys[0, :ccap] != 0).flatten()
    assert live.numel() >= 8
    lam[:, :ccap] = 1.0
    for a, b in zip(live[:4].tolist(), live[-4:].tolist()):
        keys[:, b] = keys[:, a]      # b > a: a later duplicate of a's key
        lam[:, b] = 2.0
    _, wk = _hull_tables_match(s, cfg, prev=(keys, lam))
    assert not bool((wk[0:3, :ccap] == 2.0).any())
    assert bool((wk[0:3, :ccap] == 1.0).any())


@pytest.fixture(scope="module")
def np_pile(pile):
    """The pile prepared for the two-kernel path and stepped once along
    the plain path, so its warm keys are live."""
    s, cfg = pile
    cfg = cfg.replace(**NP_KW)
    s, _ = step_with_metrics(prepare_contacts(s, cfg), cfg, plain=True)
    return s, cfg


def _banded_contacts_match(s, cfg, shard=None):
    _, rank, cand, geom, _ = banded_inputs(s, cfg, plain=True)
    before = banded_contacts.launches
    ck, lok, rbk, ngk = banded_contacts(s, cfg, rank, cand, geom, shard=shard)
    assert banded_contacts.launches == before + 1
    cp, lop, rbp, ngp = banded_contacts(s, cfg, rank, cand, geom, plain=True,
                                        shard=shard)
    assert ngk == ngp
    for f in ("body_a", "body_b", "key", "active"):
        assert torch.equal(getattr(ck, f), getattr(cp, f)), f
    assert torch.equal(lok, lop) and torch.equal(rbk, rbp)
    extent = float(geom[24:27, :N].abs().max())
    for f in ("point", "normal", "depth", "friction", "restitution"):
        err = float((getattr(ck, f) - getattr(cp, f)).abs().max())
        assert err <= 1e-5 * extent, (f, err)
    return ck, ngk


def test_banded_contacts_kernel(np_pile):
    """Kernel 2.8 (ground corners and pair manifolds, one launch) against
    the plain composition on the whole list."""
    ck, ng = _banded_contacts_match(*np_pile)
    assert int(ck.active[:ng].sum()) > 50
    assert int(ck.active[ng:].sum()) > 200


@pytest.mark.parametrize("rank", [0, 4])
def test_banded_contacts_kernel_sharded(np_pile, rank):
    """One rank of 5: its ground slot range (the last one ends in zero
    padding) and its slice of the candidate lanes in chunked mode
    (device-side tile-min window bases)."""
    _banded_contacts_match(*np_pile, shard=Shard(None, rank, 5))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_prep_consts_and_banded_sweeps_kernels(np_pile, warm):
    s, cfg = np_pile
    contacts, ranks, _, geom, _, cp, _ = banded_contact_list(s, cfg,
                                                            plain=True)
    ops = banded_operands(s, contacts, cfg,
                          (s.contact_key, s.contact_lam) if warm else None,
                          ranks, cp)
    pk = prep_kw(cfg, warm)
    cpl = prep_consts_plain(geom, ops.bases, ops.la, ops.lb, ops.cin,
                            tile=ops.tile, **pk)
    live = ops.la >= 0
    assert int(live.sum()) > 500
    posq = torch.cat([geom[0:3], geom[19:23], torch.zeros_like(geom[0:1])])
    for integrate in (None, (cfg.dt, True)):
        out = {}
        for plain in (False, True):
            # the touched slots' constants that sweep 0 built (NaN
            # elsewhere); 2.6 has no sums across contacts: bit for bit
            ck = torch.full_like(cpl, float("nan"))
            before = banded_sweeps.launches
            out[plain] = banded_sweeps(
                banded_z0(geom), ops.bases, ops.la, ops.lb, geom, ops.cin,
                tile=ops.tile, vel_iters=8, pos_iters=8 if warm else 0,
                posq=posq if integrate else None, integrate=integrate,
                consts_out=ck, plain=plain, **pk)
            assert banded_sweeps.launches == before + (not plain)
            assert torch.equal(ck[:, live], cpl[:, live])
        (zk, lk, pk_), (zp, lp, pp) = out[False], out[True]
        _rows_close("z", zk[:, :N], zp[:, :N], SOLVE_RTOL)
        _rows_close("lam", lk, lp, SOLVE_RTOL)
        if integrate:
            _rows_close("posq", pk_[:, :N], pp[:, :N], SOLVE_RTOL)


def test_two_kernel_step_kernel_path_matches_plain(np_pile):
    _steps_match(*np_pile)


@pytest.mark.parametrize("fuse_integrate", [True, False])
def test_unfused_table_step_kernel_path_matches_plain(pile, fuse_integrate):
    s, cfg = pile
    _steps_match(s, cfg.replace(contact_rebuild=1, fuse_prep=False,
                                fuse_integrate=fuse_integrate))


SWEEP_CASES = {      # (vel_on, pos_on, warm, deg_pass)
    "sweep0": (False, False, True, True),
    "vel_pos": (True, True, False, False),
    "vel": (True, False, False, False),
    "pos": (False, True, False, False),
}


def _sweep_operands(pile):
    """The unfused table solve's operands on the pile: (z0, (bases, la,
    lb, geom, cin), tile, the constants' keywords but use_split)."""
    s, cfg = pile
    cfg = cfg.replace(contact_rebuild=1, fuse_prep=False)
    geom, (table, _, warm) = _table(
        s, cfg, (s.contact_key, s.contact_lam), plain=True)
    bases, la, lb, cin = table_solve_operands(table, warm, N, cfg)
    ccap = tct.table_shape(N, cfg)[1]
    kw = prep_kw(cfg, True)
    del kw["use_split"]
    return banded_z0(geom), (bases, la, lb, geom, cin), ccap, kw


def _clone(sc):
    return type(sc)(*[t.clone() for t in sc])


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_banded_sweep_once_kernel(pile, case):
    """Kernel 2.7 on the unfused table solve's operands, each switch
    combination: sweep 0 from z0, a later sweep (2) from the plain loop's
    scratch after sweep 0 and one velocity sweep. The delta table and λ
    within SOLVE_RTOL, the live list (as a set) and the next snapshot
    table identical."""
    z0, ops, ccap, pk = _sweep_operands(pile)
    cp = ops[1].shape[0]
    sc = sweep_scratch(cp, z0.shape[1], z0.device)
    vel_on, pos_on, warm_on, deg = SWEEP_CASES[case]
    sweep = 0 if deg else 2
    if not deg:
        for s_, v in ((0, False), (1, True)):
            banded_sweep_once(sc, z0, *ops, sweep=s_, tile=ccap, vel_on=v,
                              pos_on=False, use_split=True, plain=True, **pk)
    kw = dict(sweep=sweep, tile=ccap, vel_on=vel_on, pos_on=pos_on,
              use_split=warm_on, **pk)
    sk, sp = _clone(sc), _clone(sc)
    before = banded_sweep_once.launches
    banded_sweep_once(sk, z0, *ops, **kw)
    assert banded_sweep_once.launches == before + 1
    banded_sweep_once(sp, z0, *ops, **kw, plain=True)
    n_live = int(sp.count[0])
    assert int(sk.count[0]) == n_live and 500 < n_live < cp
    assert torch.equal(torch.sort(sk.live[:n_live]).values,
                       sp.live[:n_live])
    assert torch.equal(sk.zt[sweep % 2], sp.zt[sweep % 2])
    if sweep:
        assert not bool(sk.dz[(sweep + 1) % 3].any())
    _rows_close("dz", rows_of(sk.dz[sweep % 3])[:, :N],
                rows_of(sp.dz[sweep % 3])[:, :N], SOLVE_RTOL)
    _rows_close("lam", sk.lam, sp.lam, SOLVE_RTOL)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_sharded_sweep_loop_kernel(pile, warm):
    """The whole sharded loop on one rank (a launch a sweep, no
    collective) against the plain loop and against banded_sweeps_plain."""
    z0, ops, ccap, pk = _sweep_operands(pile)
    cp = ops[1].shape[0]
    vel_iters, pos_iters = 8, 8 if warm else 0
    n_sweeps = max(vel_iters, pos_iters) + 1
    out = {}
    for plain in (False, True):
        sc = sweep_scratch(cp, z0.shape[1], z0.device)
        for s_ in range(n_sweeps):
            banded_sweep_once(sc, z0, *ops, sweep=s_, tile=ccap,
                              vel_on=0 <= s_ - 1 < vel_iters,
                              pos_on=0 <= s_ - 1 < pos_iters, use_split=warm,
                              plain=plain, **pk)
        out[plain] = (sweep_result(sc, n_sweeps - 1), sc.lam)
    z_ref, lam_ref, _ = banded_sweeps_plain(
        z0, *ops, tile=ccap, vel_iters=vel_iters, pos_iters=pos_iters,
        use_split=warm, posq=None, integrate=None, **pk)
    for z, lam in out.values():
        _rows_close("z", z[:, :N], z_ref[:, :N], SOLVE_RTOL)
        _rows_close("lam", lam, lam_ref, SOLVE_RTOL)


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_sweep0_folded_consts(pile, np_pile, rank):
    """2.7's sweep 0 on one rank's columns of the whole cin, read in place
    (rank r of 2 on the unfused table solve; of 4 on the two-kernel
    pile's padded contact list): the constants it builds equal
    prep_consts_plain's on that rank's touched slots, bit for bit, and
    one launch counts one 2.6 launch."""
    z0, (bases, la, lb, geom, cin), tile, pk = _sweep_operands(pile)
    s, cfg = np_pile
    contacts, ranks, _, ngeom, _, cp, _ = banded_contact_list(s, cfg,
                                                             plain=True)
    ops = banded_operands(s, contacts, cfg, (s.contact_key, s.contact_lam),
                          ranks, cp)
    for (z0_, b, a_, b_, g, c, t), size in (
            ((z0, bases, la, lb, geom, cin, tile), 2),
            ((banded_z0(ngeom), ops.bases, ops.la, ops.lb, ngeom, ops.cin,
              ops.tile), 4)):
        t_loc = b.shape[0] // size
        c_loc = t_loc * t
        cols = slice(rank * c_loc, (rank + 1) * c_loc)
        loc = (b[rank * t_loc:(rank + 1) * t_loc], a_[cols], b_[cols], g,
               c[:, cols])
        assert not loc[4].is_contiguous()
        kw = prep_kw(cfg, True)
        ref = prep_consts_plain(g, *loc[:3], loc[4], tile=t, **kw)
        touched = (loc[1] >= 0) | (loc[2] >= 0)
        assert int(touched.sum()) > 50
        got = torch.full_like(ref, float("nan"))
        sc = sweep_scratch(c_loc, z0_.shape[1], z0_.device)
        before = banded_sweep_once.launches
        banded_sweep_once(sc, z0_, *loc, sweep=0, tile=t, vel_on=False,
                          pos_on=False, consts_out=got, **kw)
        assert banded_sweep_once.launches == before + 1
        assert torch.equal(got[:, touched], ref[:, touched])
        # the scratch keeps the live slots' sweep constants
        live = sc.live[:int(sc.count[0])].long()
        assert torch.equal(sc.consts[:, live], ref[:42, live])


def test_sweep_kernels_graph_replay(pile):
    """A 2.1 call (replayed twice: its overflow counter resets itself) and
    a 2.7 sweep captured in a CUDA graph and replayed, against the eager
    calls."""
    s, cfg = pile
    cfg = cfg.replace(bucket_cap=128)          # overflow > 0
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    z0, ops, ccap, pk = _sweep_operands(pile)
    sc = sweep_scratch(ops[1].shape[0], z0.shape[1], z0.device)
    banded_sweep_once(sc, z0, *ops, sweep=0, tile=ccap, vel_on=False,
                      pos_on=False, use_split=True, **pk)
    eager_sc, graph_sc = _clone(sc), _clone(sc)
    kw = dict(sweep=1, tile=ccap, vel_on=True, pos_on=True, use_split=False,
              **pk)

    def cand():
        return pair_candidates(s, cfg, aabbs, order)
    eager = cand()
    banded_sweep_once(eager_sc, z0, *ops, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cand()
        banded_sweep_once(_clone(sc), z0, *ops, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cand()
        banded_sweep_once(graph_sc, z0, *ops, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph_sc.zt[1], eager_sc.zt[1])
    _rows_close("dz", rows_of(graph_sc.dz[1]), rows_of(eager_sc.dz[1]),
                SOLVE_RTOL)
    _rows_close("lam", graph_sc.lam, eager_sc.lam, SOLVE_RTOL)
    graph.replay()
    torch.cuda.synchronize()
    assert int(eager.overflow) > 0
    for name, a, b in zip(eager._fields, captured, eager):
        assert torch.equal(a, b), name


def test_table_kernels_bucket_range(pile, rain):
    """The box and hull table kernels with buckets=(1, 1) equal the
    full-range kernel's block of bucket 1, bit for bit."""
    for s, cfg, fn, hulls in ((*pile, tct.bucket_contact_table, False),
                              (*rain, tht.bucket_hull_contact_table, True)):
        if -(-s.num_bodies // 128) < 2:
            continue
        aabbs = body_aabbs(s)
        order = sweep_order(s, aabbs)
        cand = pair_candidates(s, cfg, aabbs, order)
        geom = tct.unified_geom(s, cfg, order, hulls=hulls)
        prev = (s.contact_key, s.contact_lam)
        full = fn(s, cand, cfg, prev=prev, geom=geom)
        ccap = tct.table_shape(s.num_bodies, cfg)[1]
        cap = len(cand.mask) // -(-s.num_bodies // 128)
        part = fn(s, type(cand)(*[x[cap:2 * cap] if x.dim() else x
                                  for x in cand]), cfg,
                  prev=(prev[0][:, ccap:2 * ccap], prev[1][:, ccap:2 * ccap]),
                  geom=geom, buckets=(1, 1))
        assert torch.equal(part[0], full[0][:, ccap:2 * ccap])
        assert torch.equal(part[1], full[1][:, 128:256])
        assert torch.equal(part[2], full[2][:, ccap:2 * ccap])


def _tables_match(fn, geom, n):
    """The table kernel against its plain version: fn(plain) → (table,
    meta, warm). Returns the kernel's outputs."""
    before = tct.bucket_contact_table.launches
    tk, mk, wk = fn(False)
    assert tct.bucket_contact_table.launches == before + 1
    tp, mp, wp = fn(True)
    for r in EXACT_ROWS:
        assert torch.equal(tk[r], tp[r]), r
    assert torch.equal(mk, mp)
    assert torch.equal(wk, wp)
    extent = float(geom[0:3, :n].abs().max())
    assert float((tk - tp).abs().max()) <= 1e-5 * extent
    return tk, mk, wk


@pytest.mark.parametrize("window", [8, 48])
def test_contact_table_kernel_inkernel_broadphase(pile, window):
    """cand=None: the kernel's own broad phase on the sweep order, its
    raw pairs compacted d-major into cap lanes, then the cap2 prefilter;
    at window 8 ranks overlap past the window edge (meta column 3)."""
    s, cfg = pile
    cfg = cfg.replace(sweep_window=window)
    order = sweep_order(s, body_aabbs(s))
    geom = tct.unified_geom(s, cfg, order)
    tk, mk, _ = _tables_match(lambda plain: tct.bucket_contact_table(
        s, None, cfg, prev=(s.contact_key, s.contact_lam), geom=geom,
        plain=plain), geom, N)
    assert int(tk[tct.CT_ACT].sum()) > 500
    if window == 8:
        assert float(mk[0].reshape(-1, 128)[:, 3].sum()) > 0


@pytest.mark.parametrize("gate", [(1, 0), (0, 1)])
def test_contact_table_kernel_gate(pile, gate):
    """A fired and a passed-through bucket in one launch: the latter keeps
    its persisted block and zero meta, and warm-matches its own keys."""
    s, cfg = pile
    order = sweep_order(s, body_aabbs(s))
    geom = tct.unified_geom(s, cfg, order)
    persisted, _, _ = tct.bucket_contact_table(s, None, cfg, geom=geom,
                                               plain=True)
    persisted = persisted.clone()
    persisted[0:3] += 0.25          # a stale block differs from a fresh one
    g = torch.tensor(gate, device=s.device)
    prev = (tct.table_keys(persisted), torch.rand(
        (3, persisted.shape[1]), generator=torch.Generator().manual_seed(6)
    ).to(s.device))
    tk, mk, wk = _tables_match(lambda plain: tct.bucket_contact_table(
        s, None, cfg, prev=prev, geom=geom, plain=plain,
        gate=(g, persisted)), geom, N)
    ccap = tct.table_shape(N, cfg)[1]
    b = gate.index(0)
    cols = slice(b * ccap, (b + 1) * ccap)
    assert torch.equal(tk[:, cols], persisted[:, cols])
    assert not bool(mk[:, b * 128:(b + 1) * 128].any())
    act = persisted[tct.CT_ACT, cols] > 0
    assert torch.equal(wk[0:3, cols][:, act], prev[1][:, cols][:, act])


@pytest.fixture(scope="module")
def packed(dev):
    """32 packed envs of 8 boxes (two buckets) under the packed
    configuration, so each bucket has its full shapes; stepped twice
    along the plain path, so the warm keys are live."""
    cfg = scenes.packed_env_config(32, 8)
    s = prepare_contacts(scenes.packed_envs(32, 8, device=dev), cfg)
    for _ in range(2):
        s, _ = step_with_metrics(s, cfg, plain=True)
    return s, cfg


@pytest.mark.parametrize("gate", [None, (0, 1)])
def test_contact_table_kernel_packed_envs(packed, gate):
    s, cfg = packed
    geom = tct.unified_geom(s, cfg, None)
    g = None if gate is None else (torch.tensor(gate, device=s.device),
                                   s.contact_table)
    tk, mk, _ = _tables_match(lambda plain: tct.bucket_contact_table(
        s, None, cfg, prev=(s.contact_key, s.contact_lam), geom=geom,
        plain=plain, gate=g), geom, s.num_bodies)
    assert int(tk[tct.CT_ACT].sum()) > 50
    assert float(mk[0].reshape(-1, 128)[:, 3].sum()) == 0


def _live_prev(s, cfg, seed):
    """Previous keys from a first plain table of `cfg`, random impulses."""
    _, (t0, _, _) = _table(s, cfg, None, plain=True)
    keys = tct.table_keys(t0)
    lam = torch.rand((3, keys.shape[1]),
                     generator=torch.Generator().manual_seed(seed))
    return keys, lam.to(s.device)


@pytest.mark.parametrize("mode", ["candidates", "bp_k"])
def test_contact_table_kernel_saturated_buckets(pile, mode):
    """Every capacity cut below what the buckets hold: contacts beyond
    ccap (meta column 0) and lanes beyond the prefilter's or the in-kernel
    broad phase's cap (column 2) are dropped and counted as the plain
    version drops them."""
    s, cfg = pile
    cfg = cfg.replace(**(dict(bucket_ccap=128, bucket_cap2=128)
                         if mode == "candidates" else
                         dict(bucket_ccap=128, bucket_cap=128,
                              sweep_window=16)))
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    geom = tct.unified_geom(s, cfg, order)
    cand = (pair_candidates(s, cfg, aabbs, order) if mode == "candidates"
            else None)
    prev = _live_prev(s, cfg, 10)
    _, mk, wk = _tables_match(lambda plain: tct.bucket_contact_table(
        s, cand, cfg, prev=prev, geom=geom, plain=plain), geom, N)
    meta = mk[0].reshape(-1, 128)
    assert float(meta[:, 0].sum()) > 0 and float(meta[:, 2].sum()) > 0
    assert float(wk[0].abs().sum()) > 0


def test_contact_table_warm_match_first_of_duplicate_keys(pile):
    """Previous keys with duplicates in one bucket: the first previous
    slot (index order) with the key gives the warm λ, as in the plain
    version's first match."""
    s, cfg = pile
    keys, _ = _live_prev(s, cfg, 11)
    lam = torch.ones((3, keys.shape[1]), device=s.device)
    ccap = tct.table_shape(N, cfg)[1]
    live = torch.nonzero(keys[0, :ccap] != 0).flatten()
    assert live.numel() >= 8
    for a, b in zip(live[:4].tolist(), live[-4:].tolist()):
        keys[:, b] = keys[:, a]      # b > a: a later duplicate of a's key
        lam[:, b] = 2.0
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    cand = pair_candidates(s, cfg, aabbs, order)
    geom = tct.unified_geom(s, cfg, order)
    _, _, wk = _tables_match(lambda plain: tct.bucket_contact_table(
        s, cand, cfg, prev=(keys, lam), geom=geom, plain=plain), geom, N)
    assert not bool((wk[0:3, :ccap] == 2.0).any())
    assert bool((wk[0:3, :ccap] == 1.0).any())


@pytest.mark.parametrize("mode", ["candidates", "gated"])
def test_contact_table_kernel_graph_replay(pile, mode):
    """One 2.2 call captured in a CUDA graph and replayed, against the
    eager call: with candidate lanes, and gated (a fired and a
    passed-through bucket) over the in-kernel broad phase."""
    s, cfg = pile
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    geom = tct.unified_geom(s, cfg, order)
    if mode == "candidates":
        cand, gate = pair_candidates(s, cfg, aabbs, order), None
        prev = _live_prev(s, cfg, 12)
    else:
        persisted, _, _ = tct.bucket_contact_table(s, None, cfg, geom=geom,
                                                   plain=True)
        cand = None
        gate = (torch.tensor([1, 0], device=s.device), persisted)
        prev = (tct.table_keys(persisted),
                torch.rand((3, persisted.shape[1]), device=s.device))

    def call():
        return tct.bucket_contact_table(s, cand, cfg, prev=prev, geom=geom,
                                        gate=gate)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)
    assert int(captured[0][tct.CT_ACT].sum()) > 100


def test_contact_table_kernel_beyond_the_old_shared_memory_ceiling(pile):
    """2,048 candidate lanes a bucket, 8 picks a pair and a body, no
    prefilter: a bucket's working set (~360 KB) that no block's shared
    memory holds runs on the card as in the plain version."""
    s, cfg = pile
    cfg = cfg.replace(bucket_cap=2048, bucket_cap2=0,
                      max_contacts_per_pair=8)
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    cand = pair_candidates(s, cfg, aabbs, order)
    assert cand.mask.shape[0] == 2 * 2048
    geom = tct.unified_geom(s, cfg, order)
    tk, _, _ = _tables_match(lambda plain: tct.bucket_contact_table(
        s, cand, cfg, prev=_live_prev(s, cfg, 13), geom=geom, plain=plain),
        geom, N)
    assert int(tk[tct.CT_ACT].sum()) > 500


def _geom_case(dev, case):
    """(state, cfg, order, unified_geom keywords) of a geometry-table
    case."""
    if case == "packed":            # 8,008 bodies: not a multiple of 128
        return (scenes.packed_envs(1001, 8, device=dev),
                scenes.packed_env_config(1001, 8), None, {})
    kw = {}
    if case in ("pile4k", "npad"):
        s = scenes.box_pile(4096, x_aspect=16.0, device=dev)
        cfg = scenes.pile_config(4096)
        if case == "npad":          # the generic banded path's width
            cfg = cfg.replace(contact_table=False)
            kw["npad"] = body_table_width(4096, cfg)
    elif case in ("flipped", "statics"):
        turn = flipped if case == "flipped" else statics
        s = turn(scenes.box_pile(N, x_aspect=4.0, layers=3, device=dev))
        cfg = scenes.pile_config(N)
    else:                           # hull mode: one type, then three
        s = (scenes.mesh_rain(1024, real_assets=False, device=dev)
             if case == "rain1024" else scenes.mesh_rain_mixed(
                 128, n_types=3, real_assets=False, device=dev))
        cfg = scenes.rain_config(s.num_bodies)
        kw["hulls"] = True
    return s, cfg, sweep_order(s, body_aabbs(s)), kw


@pytest.mark.parametrize("case", ["pile4k", "packed", "flipped", "statics",
                                  "rain1024", "mixed128x3", "npad"])
def test_geom_table_kernel_bitwise(dev, case):
    """csrc/geom_table.cu against unified_geom_plain, bit for bit: the 4k
    pile in its sweep order, packed envs in the identity order, bodies
    turned by 90° and 180° (−0 products in the sandwich), static bodies,
    hull mode on the 1,024-hull rain and on the 3-type library, and the
    generic banded path's explicit width. Compared as int32 bits
    (torch.equal counts −0 equal to +0); one launch a call."""
    s, cfg, order, kw = _geom_case(dev, case)
    n0 = tct.unified_geom.launches
    got = tct.unified_geom(s, cfg, order, **kw)
    ref = tct.unified_geom(s, cfg, order, plain=True, **kw)
    assert tct.unified_geom.launches == n0 + 1
    assert got.shape == ref.shape
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_geom_table_kernel_graph_replay(dev):
    """One unified_geom call captured in a CUDA graph (a host read would
    fail the capture), replayed after the poses and velocities changed in
    place: bit for bit the plain table of the new state."""
    s = scenes.box_pile(N, x_aspect=4.0, layers=3, device=dev)
    cfg = scenes.pile_config(N)
    order = sweep_order(s, body_aabbs(s))

    def call():
        return tct.unified_geom(s, cfg, order)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    moved = statics(s, seed=5)
    s.quat.copy_(moved.quat)
    s.pos.add_(0.25)
    s.vel.mul_(-2.0)
    s.omega.add_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    ref = tct.unified_geom(s, cfg, order, plain=True)
    assert torch.equal(captured.view(torch.int32), ref.view(torch.int32))


def test_packed_step_kernel_path_matches_plain(packed):
    """A rebuild step (step 32) and a gated refresh step."""
    s, cfg = packed
    _steps_match(s.replace(step_count_host=32), cfg)


def test_gated_pile_step_kernel_path_matches_plain(pile):
    s, cfg = pile
    _steps_match(s, cfg.replace(contact_rebuild_vel_factor=2.0))


@pytest.mark.parametrize("sides", [3, 5, 6, 8, 12, 20, 63])
def test_hull_table_kernel_face_sizes(dev, sides):
    """Libraries whose largest face has 3 (the octahedron) or `sides`
    (a prism) vertices, bodies squeezed into contact; on the octahedra
    the motion guard's steps too."""
    verts = octahedron_verts() if sides == 3 else prism_verts(sides)
    arrays = to_numpy(scenes.hull_rain(verts, 128, device="cpu"))
    arrays["pos"] *= np.float32([0.55, 0.45, 0.55])
    arrays["pos"][:, 1] += 0.3
    cfg = scenes.rain_config(128)
    s = prepare_contacts(state_from_arrays(arrays, dev), cfg)
    assert tht.hull_dims(s.hulls).e == sides
    for _ in range(2):
        s, _ = step_with_metrics(s, cfg, plain=True)
    tk, _ = _hull_tables_match(s, cfg)
    assert int((tk[tct.CT_ACT] * (1 - tk[tct.CT_KSGN])).sum()) > 20
    if sides == 3:
        _steps_match(s, cfg.replace(contact_rebuild_vel_factor=2.0))


# ---------------------------------------------------------------------------
# the device rollout: captured CUDA graphs, one a branch of the step
# ---------------------------------------------------------------------------

def _clone_state(s):
    return s.replace(**{f.name: getattr(s, f.name).clone()
                        for f in dataclasses.fields(s)
                        if isinstance(getattr(s, f.name), torch.Tensor)})


# every kernel wrapper (its `launches`: the calls that launched the kernel
# or recorded it into a graph being captured)
WRAPPERS = (gravity_and_velocities, sweep_window_masks, bucketed_candidates,
            tct.unified_geom, tct.table_prep, tct.bucket_contact_table,
            tht.bucket_hull_contact_table, banded_contacts,
            hull_pair_contacts,
            banded_sweeps_fused, banded_sweeps, banded_sweep_once, cg.solve)


def _counts():
    return [c.launches for c in WRAPPERS]


def _diff(before, after):
    return [b - a for a, b in zip(before, after)]


def _counting_capture(marks, read=_counts):
    """capture_graph, appending read() to `marks` just before and just
    after each capture."""
    def capture(fn, pool):
        marks.append(read())
        graph = capture_graph(fn, pool)
        marks.append(read())
        return graph
    return capture


def _state_matches(got, ref):
    """A replayed step against the eager step from the same state:
    integer fields identical, f32 within the whole-step 1e-4 (the solves'
    atomics), λ within 1e-4 of each row's largest magnitude."""
    assert got.step_count_host == ref.step_count_host
    for name in ("contact_key", "contact_order", "contact_meta",
                 "step_count"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("pos", "quat", "vel", "omega", "contact_ref"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape and (
            a.numel() == 0 or float((a - b).abs().max()) <= 1e-4), name
    if got.contact_lam.numel():
        _rows_close("lam", got.contact_lam, ref.contact_lam, SOLVE_RTOL)
    tab, tref = got.contact_table, ref.contact_table
    if tab.numel():
        for r in EXACT_ROWS:
            assert torch.equal(tab[r], tref[r]), r
        assert float((tab - tref).abs().max()) <= 1e-4


def _replays_match(s, cfg, n, want):
    """n steps of a DeviceStepper from s, each beside the eager step from
    a copy of the same state: a branch's warm-up step and its capture
    each count the eager step's launches, a replay counts none, and each
    replayed step's state is compared with the eager step's. `want`: the
    branches that must have been replayed."""
    marks = []
    stepper = DeviceStepper(s, cfg, capture=_counting_capture(marks))
    replayed = set()
    for _ in range(n):
        branch = rebuild_branch(stepper.state, cfg)
        src = _clone_state(stepper.state)
        c0 = _counts()
        ref = step(src, cfg)
        c1 = _counts()
        eager = _diff(c0, c1)
        assert any(eager)
        captured = branch in stepper.captured
        stepper.step()
        if not captured:
            assert _diff(c1, marks[-2]) == eager        # the warm-up step
            assert _diff(marks[-2], marks[-1]) == eager  # the capture
            assert _counts() == marks[-1]
            continue
        assert _counts() == c1
        _state_matches(stepper.state, ref)
        replayed.add(branch)
    assert replayed == want and stepper.captured == want
    return stepper


def _rollout_scene(name, dev, pile, np_pile):
    """(state, cfg, steps, replayed branches) of each path at test size,
    starting one step before a refresh so that both branches replay."""
    if name == "demo":
        return demo_scene(device=dev), compat_config(dt=1.0 / 60.0), 4, {None}
    if name == "pendulums":
        return (packed_pendulums(256, device=dev)[0],
                SimConfig(dt=1.0 / 120.0), 4, {None})
    if name == "pile":
        s, cfg = pile
        return s.replace(step_count_host=1), cfg, 10, {True, False}
    if name == "two_kernel":
        s, cfg = np_pile
        return s, cfg, 4, {None}
    if name in ("xla_rain", "xla_rain_mixed"):
        cfg = scenes.rain_xla_config(256 if name == "xla_rain" else 128)
        s = prepare_contacts(
            scenes.mesh_rain(256, real_assets=False, device=dev)
            if name == "xla_rain" else scenes.mesh_rain_mixed(
                128, n_types=3, real_assets=False, device=dev), cfg)
        for _ in range(2):
            s, _ = step_with_metrics(s, cfg, plain=True)
        return s, cfg, 4, {None}
    if name == "rain":
        cfg = scenes.rain_config(256)
        s = prepare_contacts(scenes.mesh_rain(256, real_assets=False,
                                              device=dev), cfg)
        for _ in range(2):
            s, _ = step_with_metrics(s, cfg, plain=True)
        return s.replace(step_count_host=1), cfg, 10, {True, False}
    cfg = scenes.packed_env_config(32, 8)
    s = prepare_contacts(scenes.packed_envs(32, 8, device=dev), cfg)
    for _ in range(2):
        s, _ = step_with_metrics(s, cfg, plain=True)
    # K = 32: a refresh, the rebuild at 32, refreshes to the one at 64
    return s.replace(step_count_host=31), cfg, 34, {True, False}


@pytest.mark.parametrize("name", ["pile", "rain", "two_kernel", "packed",
                                  "demo", "pendulums", "xla_rain",
                                  "xla_rain_mixed"])
def test_rollout_replay_matches_eager(dev, pile, np_pile, name):
    s, cfg, n, want = _rollout_scene(name, dev, pile, np_pile)
    _replays_match(s, cfg, n, want)


def test_rollout_xla_rain_reads_nothing_back(dev, pile, np_pile):
    """The generic hull path's replays under
    torch.cuda.set_sync_debug_mode("error") (a host read inside raises):
    one 2.1 masks launch, one 2.5 launch and the pair contacts' two at
    the warm-up step and as many at the capture, none over the
    replays."""
    def both():
        return (sweep_window_masks.launches, banded_sweeps.launches,
                hull_pair_contacts.launches)
    s, cfg, _, _ = _rollout_scene("xla_rain", dev, pile, np_pile)
    marks = []
    stepper = DeviceStepper(s, cfg, capture=_counting_capture(marks, both))
    c0 = both()
    stepper.step()                      # the warm-up step and capture
    assert _diff(c0, marks[0]) == _diff(marks[0], marks[1]) == [1, 1, 2]
    assert both() == marks[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            stepper.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert both() == marks[1]
    assert bool(torch.isfinite(stepper.state.pos).all())


def _guard_rain(dev):
    """24 octahedra pressed into contact under the motion guard
    (vel_factor 8, K = 4): steps 1-2 refresh, step 3 the guard
    rebuilds."""
    arrays = to_numpy(scenes.hull_rain(octahedron_verts(), 24,
                                       device="cpu"))
    arrays["pos"] *= np.float32([0.7, 0.6, 0.7])
    arrays["pos"][:, 1] += 0.3
    cfg = scenes.rain_config(24).replace(contact_rebuild_vel_factor=8.0)
    return prepare_contacts(state_from_arrays(arrays, dev), cfg), cfg


def test_rollout_replay_hull_guard(dev):
    """The guard's off-schedule steps replay one GUARDED graph, which
    decides rebuild or refresh on the device: each replayed step against
    the eager step from the same state (which reads the guard), among
    them a step the guard turns into a rebuild (a hull table launch in
    the eager step, one more `guarded_rebuilds` in the replay)."""
    s, cfg = _guard_rain(dev)
    stepper = DeviceStepper(s, cfg)
    kinds = []
    for _ in range(10):
        branch = rebuild_branch(stepper.state, cfg)
        if branch == GUARDED and branch in stepper.captured:
            src = _clone_state(stepper.state)
            h0 = tht.bucket_hull_contact_table.launches
            ref = step(src, cfg)
            kinds.append(tht.bucket_hull_contact_table.launches - h0)
            g0 = stepper.counters()["guarded_rebuilds"]
            stepper.step()
            assert stepper.counters()["guarded_rebuilds"] - g0 == kinds[-1]
            _state_matches(stepper.state, ref)
        else:
            stepper.step()
    assert 1 in kinds and 0 in kinds
    assert stepper.captured == {True, GUARDED}


def test_rollout_hull_guard_reads_nothing_back(dev):
    """A horizon of the guarded rain's replays under
    torch.cuda.set_sync_debug_mode("error") (a host read inside raises):
    its rebuilds off the schedule (`guarded_rebuilds`, read after the
    horizon) those of the eager drive from the same state over 6 steps
    (the guard's at step 3), its final poses within 5e-2 of the eager
    drive's (a horizon of a contact-rich rain amplifies the run-to-run
    differences of the solves' atomic sums: 12 steps of this rain ended
    1.1e-3 apart, phase 10's squeezed octahedra 8 steps up to 7.3e-3;
    each single step is held to 1e-4 above)."""
    s, cfg = _guard_rain(dev)
    eager, want = s, 0
    for _ in range(6):
        off = rebuild_branch(eager, cfg) == GUARDED
        h0 = tht.bucket_hull_contact_table.launches
        eager = step(eager, cfg)
        want += off and tht.bucket_hull_contact_table.launches > h0
    stepper = DeviceStepper(s, cfg)
    for _ in range(2):      # the rebuild's and the GUARDED warm-up
        stepper.step()
    assert stepper.captured == {True, GUARDED}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            stepper.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert stepper.counters()["guarded_rebuilds"] == want >= 1
    got = stepper.state
    assert got.step_count_host == eager.step_count_host == 6
    assert torch.equal(got.step_count, eager.step_count)
    for name in ("pos", "quat"):
        d = float((getattr(got, name) - getattr(eager, name)).abs().max())
        assert d <= 5e-2, (name, d)
    assert bool(torch.isfinite(got.vel).all() and torch.isfinite(
        got.omega).all())


def _cg_operands(state, cfg):
    rows, w, rhs = joint_system(apply_gravity(state, cfg), cfg)
    return rows, w, rhs, state.lam_joint, dict(
        max_iters=cfg.cg_max_iters, rel_tol=cfg.cg_rel_tol,
        abs_tol=cfg.cg_abs_tol)


@pytest.mark.parametrize("case", ["demo", "pendulums", "pendulums_k2"])
def test_joint_cg_kernel(dev, case):
    """The CG kernel against its plain version from the same system: the
    demo's first step, the 4,096 packed pendulums after 20 steps and just
    more pendulums than one slot a thread holds on this card (more slots
    a thread); iterations and stop equal, λ within 1e-5 of its largest
    magnitude, one launch a call."""
    one = cg.plan(1, dev)        # one slot a thread: the resident grid
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots1 = min(one["blocks_an_sm"] * sms, 1024) * 256
    if case == "demo":
        s, cfg = demo_scene(device=dev), compat_config(dt=1.0 / 60.0)
    else:
        e = 4096 if case == "pendulums" else slots1 // 2 + 128
        s = packed_pendulums(e, device=dev)[0]
        cfg = SimConfig(dt=1.0 / 120.0)
        for _ in range(20):
            s = step(s, cfg)
    rows, w, rhs, lam0, kw = _cg_operands(s, cfg)
    k = cg.plan(rows.j_a.shape[0], dev)["slots_a_thread"]
    assert (k > 1) == (case == "pendulums_k2")
    c0 = cg.solve.launches
    xk, ck, ik = cg.solve(rows, w, rhs, lam0, **kw)
    assert cg.solve.launches == c0 + 1
    xp, cp, ip = cg.solve(rows, w, rhs, lam0, plain=True, **kw)
    torch.cuda.synchronize()
    assert int(ik) == int(ip) >= 1 and bool(ck) == bool(cp)
    scale = max(float(xp.abs().max()), 1e-3)
    assert float((xk - xp).abs().max()) <= 1e-5 * scale


def test_rollout_sampled_horizon(pile):
    """rollout on the card with sample_every: the samples' shapes, the
    last one the final pose, finite, and the launch counts of each
    branch's warm-up step and capture, each its eager step's (the
    replays add none)."""
    s, cfg = pile
    eager = {}
    loop = s
    for _ in range(12):
        branch = rebuild_branch(loop, cfg)
        c0 = _counts()
        loop = step(loop, cfg)
        eager.setdefault(branch, _diff(c0, _counts()))
    assert set(eager) == {True, False}
    c1 = _counts()
    final, (pos, quat) = rollout(s, cfg, 12, sample_every=3)
    assert _diff(c1, _counts()) == [2 * sum(n) for n in
                                    zip(*eager.values())]
    assert pos.shape == (4, N, 3) and quat.shape == (4, N, 4)
    assert torch.equal(pos[-1], final.pos) and torch.equal(quat[-1],
                                                           final.quat)
    assert bool(torch.isfinite(pos).all() and torch.isfinite(quat).all())
    assert final.step_count_host == s.step_count_host + 12


def test_rollout_capture_failure_raises(pile, monkeypatch):
    """A step that reads the device back cannot be captured: rollout
    raises with the cause and does not step eagerly instead."""
    import physics_tpu_torch.engine as engine

    s, cfg = pile
    real = engine.gravity_and_velocities

    def reads_back(state, cfg, **kw):
        float(state.vel.sum())
        return real(state, cfg, **kw)
    monkeypatch.setattr(engine, "gravity_and_velocities", reads_back)
    with pytest.raises(RuntimeError, match="capturing a step"):
        rollout(s, cfg, 3)
    torch.cuda.synchronize()
