"""The benchmark's hull rain on the generic hull path (portbench's
configuration rain1k-xla, cell rain1k-xla.settled16) on the CPU at test
size: the plain reference (portbench/reference/hull_list_step.py) steps a
64-hull rain under rain_xla_config(64) as the port's plain step does,
from the port's own state, within the cell's limits and with the same
contact keys; the check fails what it must: the control (the reference
held in bfloat16), a step that leaves the state unchanged, and one that
does so in the window only. A traced run reads the contact list's
counters (list_live_pct)."""

import copy
import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from physics_tpu_torch import scenes
from physics_tpu_torch.engine import step as port_step
from portbench.calls import stepper as stepper_mod
from portbench.core import bench, check
from portbench.core import spec as spec_mod
from portbench.core.program import build_state
from portbench.reference import hull_list_step as ref
from portbench.reference.state import Config
from portbench.scenes import mesh_rain

ROOT = Path(__file__).resolve().parent.parent
CELL = "rain1k-xla.settled16"
N = 64


def _conf(n):
    conf = json.load(open(ROOT / "portbench/configs/rain1k-xla.json"))
    conf = copy.deepcopy(conf)
    conf["scene"]["n_bodies"] = n
    conf["config"]["args"] = [n]
    cfg = scenes.rain_xla_config(n)
    conf["sim"] = {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(cfg).items()}
    return conf, cfg


def test_configuration_is_the_factorys():
    """The file's sim is rain_xla_config(1024)'s, and its scene rain1k's."""
    conf = json.load(open(ROOT / "portbench/configs/rain1k-xla.json"))
    assert conf["sim"] == _conf(1024)[0]["sim"]
    rain = json.load(open(ROOT / "portbench/configs/rain1k.json"))
    assert conf["scene"] == rain["scene"]


@pytest.mark.parametrize("seed", [3, 41, 2**31 + 1])
def test_reference_steps_as_the_port(seed):
    """12 settling steps of the port's plain step, then 5 more, each
    checked against the reference's step from the port's state before
    it: keys identical, every gap within the cell's limits."""
    torch.set_num_threads(2)
    conf, cfg = _conf(N)
    arrays = mesh_rain.make(conf["scene"], seed)
    st = build_state(arrays, cfg, "cpu")
    rcfg = Config(**conf["sim"])
    rcfg.gravity = tuple(rcfg.gravity)
    base = ref.initial_state(arrays, rcfg, "cpu")
    assert base.contact_key.shape == (1,) + tuple(st.contact_key.shape)
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
        assert torch.equal(st.contact_key, want.contact_key[0])
        assert check.verdict(got, limits), got
        pairs += int((st.contact_key > 0).sum())
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


def test_traced_run_reads_the_list_counters(monkeypatch):
    """On the CPU no kernel runs, so the banded roofline and the stages'
    device time find nothing to read; the counters of the span pass give
    the list's live share (its timed calls cut short)."""
    from portbench.core import spans

    monkeypatch.setattr(spans, "TIMED_S", 0.05)
    out = _run(2**31 + 11, trace=True)
    assert out.correct, out.numbers
    assert 0.0 < out.per_layer["list_live_pct"] < 100.0
    assert "banded_roofline_pct" not in out.per_layer
    assert "glue_list_us_per_step" not in out.per_layer
