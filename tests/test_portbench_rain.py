"""The benchmark's hull rain (portbench's configuration rain1k, cell
rain1k.settled16) on the CPU at test size: the scene builder's arrays
are the port's scenes.mesh_rain(1024, seed) bit for bit; the plain
reference (portbench/reference/hull_step.py) steps a 64-hull rain as the
port's plain step does, from the port's own state, within the cell's
limits and with the same contact keys; and the check fails what it
must: the control (the reference held in bfloat16), a step that leaves
the state unchanged, and one that does so in the window only. A traced
run reads the hull table's counters (hull_sat_pass_pct)."""

import copy
import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from physics_tpu_torch import scenes
from physics_tpu_torch.engine import prepare_contacts
from physics_tpu_torch.engine import step as port_step
from portbench.calls import stepper as stepper_mod
from portbench.core import bench, check
from portbench.core import spec as spec_mod
from portbench.core.program import build_state
from portbench.reference import hull_step as ref
from portbench.reference.state import Config
from portbench.reference.table import CT_ACT, CT_KSGN
from portbench.scenes import mesh_rain

ROOT = Path(__file__).resolve().parent.parent
CELL = "rain1k.settled16"
N = 64


def _conf(n):
    conf = json.load(open(ROOT / "portbench/configs/rain1k.json"))
    conf = copy.deepcopy(conf)
    conf["scene"]["n_bodies"] = n
    conf["config"]["args"] = [n]
    cfg = scenes.rain_config(n)
    conf["sim"] = {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(cfg).items()}
    return conf, cfg


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_scene_is_the_ports(seed):
    conf, cfg = _conf(1024)
    got = build_state(mesh_rain.make(conf["scene"], seed), cfg, "cpu")
    want = prepare_contacts(scenes.mesh_rain(1024, seed=seed, size=0.5,
                                             bevel=0.1, device="cpu"), cfg)
    for name, x in _fields(want).items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(getattr(got, name), x), name
    for part in ("shapes", "hulls"):
        for name, x in _fields(getattr(want, part)).items():
            assert torch.equal(getattr(getattr(got, part), name), x), name


@pytest.mark.parametrize("seed", [3, 41, 2**31 + 1])
def test_reference_steps_as_the_port(seed):
    """12 settling steps of the port's plain step, then 5 more (a
    rebuild, three refreshes, a rebuild) each checked against the
    reference's step from the port's state before it."""
    torch.set_num_threads(2)
    conf, cfg = _conf(N)
    arrays = mesh_rain.make(conf["scene"], seed)
    st = build_state(arrays, cfg, "cpu")
    base = ref.initial_state(arrays, Config(**conf["sim"]), "cpu")
    rcfg = Config(**conf["sim"])
    rcfg.gravity = tuple(rcfg.gravity)
    for _ in range(12):
        st = port_step(st, cfg)
    limits = json.load(open(ROOT / f"portbench/checks/{CELL}.json")
                       )["limits"]
    pairs = 0
    for _ in range(5):
        snap = {k: getattr(st, k) for k in ref.SNAPSHOT}
        snap["step"] = st.step_count_host
        want = ref.step(ref.from_snapshot(base, snap), rcfg)
        st = port_step(st, cfg)
        got = check.state_gaps({k: getattr(st, k) for k in ref.SNAPSHOT},
                               want)
        assert got["key_mismatch"] == 0
        assert torch.equal(st.contact_key, want.contact_key)
        assert check.verdict(got, limits), got
        table = st.contact_table
        pairs += int(((table[CT_ACT] > 0) & (table[CT_KSGN] == 0)).sum())
    assert pairs > 0                    # hull-hull contacts were checked


def _spec():
    """The cell at 64 hulls, two settle calls, one traced call."""
    spec = spec_mod.load(CELL)
    spec.conf = _conf(N)[0]
    spec.traffic = dict(spec.traffic, settle_steps=32, trace_calls=1)
    return spec


def _run(seed, control=False, trace=False):
    torch.set_num_threads(2)
    return bench.run_cell(_spec(), seed, 0.2, trace, "cpu",
                          time.perf_counter(), control=control)


def test_sound_and_control():
    out = _run(2**31 + 3, control=True)
    assert out.correct, out.numbers
    assert out.numbers["key_mismatch"] == 0
    assert not check.verdict(out.numbers["control"], out.limits)


def test_state_left_unchanged_fails(monkeypatch):
    from physics_tpu_torch import engine

    monkeypatch.setattr(engine, "step", lambda state, cfg: state)
    out = _run(2**31 + 5)
    assert not out.correct, out.numbers


def test_state_left_unchanged_in_the_window_fails(monkeypatch):
    call = stepper_mod.Call.call

    def stalled(self, k, after_step=None):
        if k >= self.schedule.settle_calls:
            self.stepper.step = lambda: self.stepper.state
        call(self, k, after_step)

    monkeypatch.setattr(stepper_mod.Call, "call", stalled)
    out = _run(2**31 + 9)
    assert not out.correct, out.numbers


def test_traced_run_reads_the_hull_counters(monkeypatch):
    """On the CPU no kernel runs, so the roofline finds nothing to read;
    the counters of the span pass give the SAT's pass share (its timed
    calls cut short)."""
    from portbench.core import spans

    monkeypatch.setattr(spans, "TIMED_S", 0.05)
    out = _run(2**31 + 11, trace=True)
    assert out.correct, out.numbers
    assert 0.0 < out.per_layer["hull_sat_pass_pct"] < 100.0
    assert "hull_roofline_pct" not in out.per_layer
