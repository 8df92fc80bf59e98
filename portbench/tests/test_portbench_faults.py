"""The check fails what it must, on the CPU at test size through the
rest of a run (bench.run_cell, past the harness's look for a card): the
control (the reference with its state held in bfloat16) reads not
correct on every cell, and so does the program with its timed path
broken underneath: a step that returns its state unchanged (from the
start, and in the window only, after set-up's settled calls), and an
answer altered where it is produced (one body's gathered position moved
by 1 cm)."""

import time

import pytest
import torch

from portbench.core import bench, check
from portbench.calls import stepper
from portbench.tests.tiny import tiny_spec

CELLS = ["pile4k.settled16", "envs4096x8.reset4", "envs4096x8.still32"]


def run(workload, control=False):
    torch.set_num_threads(2)
    spec = tiny_spec(workload)
    return bench.run_cell(spec, 2**31 + 3, 0.2, False, "cpu",
                          time.perf_counter(), control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_and_control(workload):
    out = run(workload, control=True)
    assert out.correct, out.numbers
    assert not check.verdict(out.numbers["control"], out.limits)


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged_fails(workload, monkeypatch):
    from physics_tpu_torch import engine

    monkeypatch.setattr(engine, "step", lambda state, cfg: state)
    out = run(workload)
    assert not out.correct, out.numbers


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged_in_the_window_fails(workload, monkeypatch):
    call = stepper.Call.call

    def stalled(self, k, after_step=None):
        if k >= self.schedule.settle_calls:
            self.stepper.step = lambda: self.stepper.state
        call(self, k, after_step)

    monkeypatch.setattr(stepper.Call, "call", stalled)
    out = run(workload)
    assert not out.correct, out.numbers


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_fails(workload, monkeypatch):
    call = stepper.Call.call

    def altered(self, k, after_step=None):
        call(self, k, after_step)
        self.out[5, 1] += 0.01

    monkeypatch.setattr(stepper.Call, "call", altered)
    out = run(workload)
    assert not out.correct, out.numbers
    assert out.numbers["pose_gap_m"] > out.limits["pose_gap_m"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run(workload):
    """A --trace 1 run drives the same calls and the reference follows
    the traced ones: correct, capture_ms read, the breakdown's lists."""
    torch.set_num_threads(2)
    spec = tiny_spec(workload)
    out = bench.run_cell(spec, 2**31 + 11, 0.2, True, "cpu",
                         time.perf_counter())
    assert out.correct, out.numbers
    assert out.per_layer["capture_ms"] > 0
    assert set(out.breakdown) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out.breakdown.values())
