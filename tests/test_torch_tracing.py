"""The step's stage spans and device counters (physics_tpu_torch.tracing)
on the CPU, on a small table pile (K = 4), 16 packed envs with the
gated refresh (K = 4), a 64-hull rain on the hull table (K = 4), their
rebuild and refresh steps, and a 64-hull rain on the generic hull path
(rain_xla_config: a rebuild every step, the contact list's four list_*
stages in place of `table`).

Under a TorchDispatchMode, each aten op of a step is logged beside the
stage boundaries that would launch a marker (tracing._launch, which
launches nothing off the card): with tracing on every op falls after a
boundary and before the step's `end`, so inside exactly one stage, and
the stages come in tracing.STAGES' order; with tracing off no boundary
launches and no op touches the stepper's counters. `step` dispatches
fewer ops than `step_with_metrics` (it computes no metrics) and gives the
same state, and step_with_metrics' keys are as before. Through the
stepper with an eager stand-in for its graphs, the gate's counters equal
a count of refresh_gate over the same refresh steps, and the hull
table's counters a count of the plain table's SAT lanes and of those
its SAT did not separate; the generic hull path's counters a count of
its plain contact list's slots and live contacts and of the step's
band_overflow and prefilter_overflow, and of its pair contacts' SAT
lanes and overlaps (list_sat_lanes, list_sat_pass: counted only with
tracing on and a counter vector in place). On the card (marked cuda) a
profiled replay of a graph captured with tracing on runs the stage
markers in order, and one captured with tracing off none; the hull
table kernel's counts equal its plain version's, and the generic hull
path's pair-contact kernel's its plain version's; a generic hull step's
graph captured with tracing off has as many nodes as one captured with
the tracing calls taken out, and a replay of one captured with tracing
on puts every device operation in one stage."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from physics_tpu_torch import scenes, tracing
from physics_tpu_torch.engine import (
    DeviceStepper,
    prepare_contacts,
    step,
    step_with_metrics,
)
from physics_tpu_torch.solver import contacts as tc


def _pile(device="cpu"):
    cfg = scenes.pile_config(256)
    return prepare_contacts(scenes.box_pile(256, x_aspect=4.0,
                                            device=device), cfg), cfg


def _packed(device="cpu"):
    cfg = scenes.packed_env_config(16, 8).replace(contact_rebuild=4)
    return prepare_contacts(scenes.packed_envs(16, 8, device=device),
                            cfg), cfg


def _rain(device="cpu"):
    cfg = scenes.rain_config(64)
    return prepare_contacts(scenes.mesh_rain(64, device=device), cfg), cfg


def _rain_xla(device="cpu", n=64, **kw):
    cfg = scenes.rain_xla_config(n).replace(**kw)
    return prepare_contacts(scenes.mesh_rain(n, device=device), cfg), cfg


SCENES = {"pile": _pile, "packed": _packed}
# the scenes of the stage and tracing-off checks: the box tables', the
# hull table's and the generic hull path's
ALL_SCENES = {**SCENES, "rain": _rain, "rain_xla": _rain_xla}
# the stages a step of each path runs, in order
TABLE_STAGES = list(tracing.STAGES[:tracing.STAGES.index("end") + 1])
LIST_STAGES = ["forces", "pairs", "list_ground", "list_prefilter",
               "list_manifolds", "list_select", "solve", "writeback", "end"]
METRIC_KEYS = {"cg_iters", "cg_converged", "pair_overflow",
               "contact_overflow", "contact_count", "max_penetration",
               "normal_impulse_sum", "band_overflow"}


def eager_capture(fn, pool):
    return SimpleNamespace(replay=fn, pool=lambda: None)


class OpLog(TorchDispatchMode):
    """Every aten op dispatched, as ("op", name, its tensor arguments);
    not the profiler's ops that open and close the pt.* ranges."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [a for a in (*args, *kwargs.values())
                   if isinstance(a, torch.Tensor)]
        if not str(func).startswith("profiler."):
            self.log.append(("op", str(func), tensors))
        return func(*args, **kwargs)


@pytest.fixture
def log(monkeypatch):
    """The ops and marker launches of the block, in order; tracing off
    again after the test."""
    out = []
    real = tracing._launch

    def spy(idx, device):
        out.append(("mark", tracing.STAGES[idx], ()))
        real(idx, device)
    monkeypatch.setattr(tracing, "_launch", spy)
    yield out
    tracing.enable(False)


def _stages_of(log):
    """The stage of each op of one step's log: the last marker before it
    (None before the first and after `end`)."""
    cur, got = None, []
    for kind, name, _ in log:
        if kind == "mark":
            cur = None if name == "end" else name
        else:
            got.append((name, cur))
    return got


@pytest.mark.parametrize("scene", list(ALL_SCENES))
def test_every_op_falls_in_one_stage_in_order(scene, log):
    s, cfg = ALL_SCENES[scene]()
    tracing.enable(True)
    for k in range(2):                        # a rebuild, then a refresh
        log.clear()
        with OpLog(log):
            s = step(s, cfg)
        marks = [name for kind, name, _ in log if kind == "mark"]
        want = LIST_STAGES if scene == "rain_xla" else TABLE_STAGES
        assert marks == want, (k, marks)
        assert log[0][0] == "mark" and log[-1] == ("mark", "end", ())
        ops = _stages_of(log)
        assert len(ops) > 50
        assert all(st is not None for _, st in ops)


def test_gated_refresh_counts_in_table_stage(log):
    """The gate's counter ops on a gated refresh through the stepper lie
    in the table stage, and write the counters' vector."""
    s, cfg = _packed()
    tracing.enable(True)
    stepper = DeviceStepper(s, cfg, capture=eager_capture)
    stepper.step()                            # the rebuild branch
    log.clear()
    with OpLog(log):
        stepper.step()                        # the refresh's warm-up
    ptr = stepper._counters.untyped_storage().data_ptr()
    touched = [st for (kind, name, ts), (_, st) in zip(
        [e for e in log if e[0] == "op"], _stages_of(log))
        if any(t.untyped_storage().data_ptr() == ptr for t in ts)]
    assert touched and set(touched) == {"table"}


@pytest.mark.parametrize("scene", list(ALL_SCENES))
def test_tracing_off_launches_and_counts_nothing(scene, log):
    s, cfg = ALL_SCENES[scene]()
    stepper = DeviceStepper(s, cfg, capture=eager_capture)
    with OpLog(log):
        for _ in range(6):
            stepper.step()
    assert not [e for e in log if e[0] == "mark"]
    ptr = stepper._counters.untyped_storage().data_ptr()
    assert not [name for kind, name, ts in log
                if any(t.untyped_storage().data_ptr() == ptr for t in ts)]
    assert stepper.counters() == dict.fromkeys(tracing.COUNTERS, 0)


@pytest.mark.parametrize("scene", list(SCENES))
def test_step_dispatches_no_metrics(scene):
    s, cfg = SCENES[scene]()
    for _ in range(2):                        # a rebuild, then a refresh
        a, b = [], []
        with OpLog(a):
            new = step(s, cfg)
        with OpLog(b):
            ref, m = step_with_metrics(s, cfg)
        assert len(a) < len(b) - 5, (len(a), len(b))
        assert set(m) == METRIC_KEYS
        for f in dataclasses.fields(new):
            x = getattr(new, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(ref, f.name)), f.name
        s = new


def test_gate_counters_equal_refresh_gate(monkeypatch):
    """48 packed envs (3 buckets), the bodies of the first two static, so
    that the gate fires buckets 1 and 2 only (a bucket folds in the
    next), 10 steps (7 gated refreshes): gate_fired and gate_buckets
    through the stepper, its graphs captured with tracing on, against a
    loop of step counting refresh_gate's output."""
    cfg = scenes.packed_env_config(48, 8).replace(contact_rebuild=4)
    s0 = prepare_contacts(scenes.packed_envs(48, 8, device="cpu"), cfg)
    im, ii = s0.inv_mass.clone(), s0.inv_inertia.clone()
    im[:256], ii[:256] = 0.0, 0.0
    s0 = s0.replace(inv_mass=im, inv_inertia=ii)
    fired = buckets = 0
    real = tc.refresh_gate

    def spy(*a, **k):
        nonlocal fired, buckets
        g = real(*a, **k)
        fired += int(g.sum())
        buckets += g.numel()
        return g
    monkeypatch.setattr(tc, "refresh_gate", spy)
    s = s0
    for _ in range(10):
        s = step(s, cfg)
    monkeypatch.setattr(tc, "refresh_gate", real)
    assert (fired, buckets) == (14, 21)
    tracing.enable(True)
    try:
        stepper = DeviceStepper(s0, cfg, capture=eager_capture)
        for _ in range(10):
            stepper.step()
    finally:
        tracing.enable(False)
    got = stepper.counters()
    assert got == {**dict.fromkeys(tracing.COUNTERS, 0),
                   "gate_fired": fired, "gate_buckets": buckets}
    stepper.reset_counters()
    assert stepper.counters() == dict.fromkeys(tracing.COUNTERS, 0)


def _plain_sat_counts(monkeypatch):
    """[SAT lanes, lanes not separated] of the plain hull table's calls
    from now on: the prefilter's surviving lanes (every hull of the rain
    is movable, so each survivor is a SAT lane) and the SAT's verdict on
    them."""
    from physics_tpu_torch.ops import hull_table as ht

    got, lanes = [0, 0], []
    real_filter, real_select = ht.obb_prefilter, ht._select_pass

    def prefilter(*a, **k):
        out = real_filter(*a, **k)
        lanes.append(out[0] >= 0)
        return out

    def select(*a, **k):
        sp = real_select(*a, **k)
        live = lanes.pop()
        got[0] += int(live.sum())
        got[1] += int((live & ~sp["separated"]).sum())
        return sp
    monkeypatch.setattr(ht, "obb_prefilter", prefilter)
    monkeypatch.setattr(ht, "_select_pass", select)
    return got


def test_hull_counters_equal_the_plain_lanes(monkeypatch):
    """A 64-hull rain through the stepper, 10 steps (3 rebuilds through
    the hull table) with tracing on, against the plain table's SAT lanes
    and overlaps counted as it runs; with tracing off the same steps
    count nothing."""
    s0, cfg = _rain()
    want = _plain_sat_counts(monkeypatch)
    tracing.enable(True)
    try:
        stepper = DeviceStepper(s0, cfg, capture=eager_capture)
        for _ in range(10):
            stepper.step()
    finally:
        tracing.enable(False)
    got = stepper.counters()
    assert got["hull_sat_lanes"] == want[0] > 0
    assert got["hull_sat_pass"] == want[1]
    assert 0 < want[1] < want[0]
    stepper = DeviceStepper(s0, cfg, capture=eager_capture)
    for _ in range(10):
        stepper.step()
    assert stepper.counters() == dict.fromkeys(tracing.COUNTERS, 0)


def test_list_counters_equal_the_plain_list(monkeypatch):
    """A 192-hull rain on the generic hull path, its prefilter cut to 128
    lanes and its solve window to 128 ranks so that both drop, 8 steps
    through the stepper with tracing on, against a loop of
    step_with_metrics: list_slots and list_live the plain contact list's
    length and active contacts, prefilter_dropped and band_dropped the
    step's prefilter_overflow and band_overflow, list_sat_lanes and
    list_sat_pass the pair contacts' lanes with cand.mask and those the
    plain manifolds' SAT did not separate; with tracing off the same
    steps count nothing."""
    from physics_tpu_torch.ops import hullhull_batched as hhb

    s0, cfg = _rain_xla(n=192, hull_prefilter_cap=128, pallas_window=128)
    want = dict.fromkeys(tracing.COUNTERS, 0)
    real = tc.hull_contact_list
    real_sm = hhb.shared_hull_manifolds_sm

    def spy(*a, **k):
        cl = real(*a, **k)
        want["list_slots"] += cl.contacts.body_a.shape[0]
        want["list_live"] += int(cl.contacts.active.sum())
        return cl

    def spy_sm(state, cand, types=(0, 0), with_separated=False):
        sm, separated = real_sm(state, cand, types, with_separated=True)
        want["list_sat_lanes"] += int(cand.mask.sum())
        want["list_sat_pass"] += int((cand.mask & ~separated).sum())
        return (sm, separated) if with_separated else sm
    monkeypatch.setattr(tc, "hull_contact_list", spy)
    monkeypatch.setattr(hhb, "shared_hull_manifolds_sm", spy_sm)
    s = s0
    for _ in range(8):
        s, m = step_with_metrics(s, cfg)
        want["prefilter_dropped"] += int(m["prefilter_overflow"])
        want["band_dropped"] += int(m["band_overflow"])
    monkeypatch.setattr(tc, "hull_contact_list", real)
    monkeypatch.setattr(hhb, "shared_hull_manifolds_sm", real_sm)
    assert want["prefilter_dropped"] > 0 and want["band_dropped"] > 0
    assert 0 < want["list_live"] < want["list_slots"]
    assert 0 < want["list_sat_pass"] < want["list_sat_lanes"]
    tracing.enable(True)
    try:
        stepper = DeviceStepper(s0, cfg, capture=eager_capture)
        for _ in range(8):
            stepper.step()
    finally:
        tracing.enable(False)
    assert stepper.counters() == want
    stepper = DeviceStepper(s0, cfg, capture=eager_capture)
    for _ in range(8):
        stepper.step()
    assert stepper.counters() == dict.fromkeys(tracing.COUNTERS, 0)


@pytest.mark.parametrize("types", [1, 3])
def test_list_sat_counters_count_only_while_tracing(types):
    """hull_pair_contacts (the plain version on the CPU) on a 64-hull
    rain settled 6 steps, one hull type or the 3-type library: with
    tracing on inside tracing.counting it adds the lanes with cand.mask
    to list_sat_lanes and those its SAT found overlapping, no more, to
    list_sat_pass; with tracing off, or with no counter vector in place,
    it adds nothing."""
    from physics_tpu_torch.ops.hull_list import hull_pair_contacts
    from physics_tpu_torch.ops.narrowphase import hull_obb_prefilter

    cfg = scenes.rain_xla_config(64)
    s = (scenes.mesh_rain(64, device="cpu") if types == 1 else
         scenes.mesh_rain_mixed(64, n_types=3, real_assets=False,
                                device="cpu"))
    s = prepare_contacts(s, cfg)
    for _ in range(6):
        s, _ = step_with_metrics(s, cfg)
    _, _, cand, _, _ = tc.banded_inputs(s, cfg, hulls=True)
    cand, _ = hull_obb_prefilter(s, cand, cfg.hull_prefilter_cap)
    i = tracing.COUNTERS.index("list_sat_lanes")
    sink = torch.zeros((len(tracing.COUNTERS),), dtype=torch.int64)
    with tracing.counting(sink):
        hull_pair_contacts(s, cand, cfg)
    assert not sink.any()
    tracing.enable(True)
    try:
        hull_pair_contacts(s, cand, cfg)
        assert not sink.any()
        with tracing.counting(sink):
            hull_pair_contacts(s, cand, cfg)
    finally:
        tracing.enable(False)
    lanes, passed = sink[i].item(), sink[i + 1].item()
    assert lanes == int(cand.mask.sum()) > 0
    assert 0 < passed <= lanes
    assert sink.sum().item() == lanes + passed


def test_recapture_drops_the_graphs_and_logs_each_capture():
    s, cfg = _pile()
    captures = []

    def capture(fn, pool):
        captures.append(fn)
        return eager_capture(fn, pool)
    stepper = DeviceStepper(s, cfg, capture=capture)
    for _ in range(3):                        # rebuild, refresh, refresh
        stepper.step()
    assert len(captures) == 2 and stepper.captured == {True, False}
    stepper.recapture()
    assert stepper.captured == set()
    for _ in range(2):                        # refresh, rebuild
        stepper.step()
    assert len(captures) == 4 and stepper.captured == {True, False}
    assert [b for b, _, _ in stepper.capture_log] == [True, False, False,
                                                      True]
    assert all(w >= 0 and c >= 0 for _, w, c in stepper.capture_log)


@pytest.mark.cuda
@pytest.mark.parametrize("on", [True, False])
def test_replayed_markers_on_the_card(on):
    """A replayed refresh step of the pile, profiled: stage_mark<0..5> in
    order when its graph was captured with tracing on, none when off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s, cfg = _pile("cuda")
    tracing.enable(on)
    try:
        stepper = DeviceStepper(s, cfg)
        for _ in range(3):
            stepper.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stepper.step()                    # a refresh, replayed
            torch.cuda.synchronize()
    finally:
        tracing.enable(False)
    dev = sorted((e.time_range.start, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    marks = [name for _, name in dev if "stage_mark" in name]
    if not on:
        assert marks == []
        return
    assert [int(m.split("stage_mark<")[1][0]) for m in marks] == \
        [tracing.STAGES.index(k) for k in TABLE_STAGES]
    host = {e.name for e in prof.events()
            if e.device_type != DeviceType.CUDA}
    assert "pt.replay.False" in host


@pytest.mark.cuda
def test_hull_kernel_counts_as_the_plain_table():
    """The hull table kernel's SAT lane and overlap counts on the card
    equal the plain version's from the same operands, on a 1,024-hull
    rain settled 40 steps, and a call outside tracing counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from physics_tpu_torch.ops import hull_table as ht
    from physics_tpu_torch.ops.broadphase import (
        body_aabbs,
        pair_candidates,
        sweep_order,
    )
    from physics_tpu_torch.ops.contact_table import unified_geom

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scenes.rain_config(1024)
    s = prepare_contacts(scenes.mesh_rain(1024, device="cuda"), cfg)
    for _ in range(40):
        s = step(s, cfg)
    aabbs = body_aabbs(s)
    order = sweep_order(s, aabbs)
    cand = pair_candidates(s, cfg, aabbs, order)
    geom = unified_geom(s, cfg, order, hulls=True)
    prev = (s.contact_key, s.contact_lam)
    counts = {}
    for plain in (False, True):
        sink = torch.zeros((len(tracing.COUNTERS),), dtype=torch.int64,
                           device="cuda")
        tracing.enable(True)
        try:
            with tracing.counting(sink):
                ht.bucket_hull_contact_table(s, cand, cfg, prev=prev,
                                             geom=geom, plain=plain)
        finally:
            tracing.enable(False)
        counts[plain] = sink.tolist()
    i = tracing.COUNTERS.index("hull_sat_lanes")
    assert counts[False] == counts[True]
    assert counts[False][i] > counts[False][i + 1] > 0
    sink = torch.zeros((len(tracing.COUNTERS),), dtype=torch.int64,
                       device="cuda")
    with tracing.counting(sink):
        ht.bucket_hull_contact_table(s, cand, cfg, prev=prev, geom=geom)
    assert sink.tolist() == [0] * len(tracing.COUNTERS)


@pytest.mark.cuda
def test_list_kernel_counts_as_the_plain_list():
    """The generic hull path's pair contacts on the card (csrc/
    hull_list.cu) count the SAT lanes and overlaps as the plain version
    does from the same candidates, on a 1,024-hull rain settled 40 steps,
    and a call outside tracing counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from physics_tpu_torch.ops.hull_list import hull_pair_contacts
    from physics_tpu_torch.ops.narrowphase import hull_obb_prefilter

    s, cfg = _rain_xla("cuda", n=1024)
    for _ in range(40):
        s = step(s, cfg)
    _, _, cand, _, _ = tc.banded_inputs(s, cfg, hulls=True)
    cand, _ = hull_obb_prefilter(s, cand, cfg.hull_prefilter_cap)
    counts = {}
    for plain in (False, True):
        sink = torch.zeros((len(tracing.COUNTERS),), dtype=torch.int64,
                           device="cuda")
        tracing.enable(True)
        try:
            with tracing.counting(sink):
                hull_pair_contacts(s, cand, cfg, plain=plain)
        finally:
            tracing.enable(False)
        counts[plain] = sink.tolist()
    i = tracing.COUNTERS.index("list_sat_lanes")
    assert counts[False] == counts[True]
    assert counts[False][i] >= counts[False][i + 1] > 0
    sink = torch.zeros((len(tracing.COUNTERS),), dtype=torch.int64,
                       device="cuda")
    with tracing.counting(sink):
        hull_pair_contacts(s, cand, cfg)
    assert sink.tolist() == [0] * len(tracing.COUNTERS)


def _graph_nodes(graph) -> int:
    """The nodes of a captured graph (csrc/trace.cu tr_graph_nodes)."""
    import ctypes

    from physics_tpu_torch import _build

    out = ctypes.c_ulonglong(0)
    _build.check(_build.library().tr_graph_nodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(out)),
        "tr_graph_nodes")
    return out.value


@pytest.mark.cuda
def test_generic_hull_graph_nodes_and_replayed_stages(monkeypatch):
    """A 1,024-hull rain on the generic hull path, settled 40 steps: the
    stepper's graph captured with tracing off has as many nodes as one
    captured with tracing.stage and tracing.count taken out (the step
    before its spans and counters); a replay of one captured with
    tracing on runs the markers of LIST_STAGES in order, with every
    device operation between the first and the `end` marker."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    s, cfg = _rain_xla("cuda", n=1024)
    for _ in range(40):
        s = step(s, cfg)

    def nodes():
        stepper = DeviceStepper(s, cfg)
        stepper.step()
        (graph,) = stepper._graphs.values()
        return _graph_nodes(graph)
    off = nodes()
    with monkeypatch.context() as m:
        m.setattr(tracing, "stage", lambda name, device: None)
        m.setattr(tracing, "count", lambda name, value: None)
        bare = nodes()
    assert off == bare > 100
    tracing.enable(True)
    try:
        stepper = DeviceStepper(s, cfg)
        stepper.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stepper.step()
            torch.cuda.synchronize()
    finally:
        tracing.enable(False)
    dev = sorted((e.time_range.start, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("pt."))
    marks = [(i, int(n.split("stage_mark<")[1].split(">")[0]))
             for i, (_, n) in enumerate(dev) if "stage_mark" in n]
    assert [tracing.STAGES[k] for _, k in marks] == LIST_STAGES
    assert marks[0][0] == 0 and marks[-1][0] == len(dev) - 1
