"""engine.rollout and its device stepper on the CPU.

On a CUDA state `rollout` replays one captured CUDA graph per branch of
the step (engine.DeviceStepper): the host picks each step's branch
(solver.contacts.rebuild_branch), runs the first step of each branch
eagerly, captures that branch over static state buffers and replays it
after. Here the capture is an eager stand-in (its "replay" runs the
recorded step on the static buffers), so the stepper's schedule, static
buffers, branch forcing and sampling are checked against a loop of
`step`, bit for bit, on the paths at small sizes: the anchored table
pile (K = 4), the two-kernel pile (one branch), a hull rain with the
motion guard on (its off-schedule steps are one GUARDED branch: the
guard's predicate, then the rebuild or the refresh step as it decides on
the device; the stand-in for the composed graph reads the predicate's
flag), packed envs with the gated refresh, and the jointed paths without
contacts (one branch): the reference's demo scene under compat_config
and packed pendulums. The CPU `rollout` (a loop) is held to the same
loop, with and without sampling. Then the branch the stepper picks
against the branch step_with_metrics takes, the GUARDED steps' device
tally, and the refresh gate's threshold compared as a Python float
against the f32 tensor it replaced, bit for bit.

All comparisons are exact: the same plain operations run in the same
order on the same inputs.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from physics_tpu_torch import engine, scenes
from physics_tpu_torch.config import SimConfig, compat_config
from physics_tpu_torch.engine import (
    DeviceStepper,
    prepare_contacts,
    rollout,
    step,
    step_with_metrics,
)
from physics_tpu_torch.io.primitives import octahedron_verts
from physics_tpu_torch.ops.forces import apply_gravity
from physics_tpu_torch.ops.integrator import integrate_velocities
from physics_tpu_torch.scene import demo_scene
from physics_tpu_torch.solver import cg
from physics_tpu_torch.solver import contacts as tc
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_pendulums import packed_pendulums


def _pile():
    cfg = scenes.pile_config(256)
    return prepare_contacts(scenes.box_pile(256, x_aspect=4.0,
                                            device="cpu"), cfg), cfg


def _two_kernel():
    cfg = scenes.pile_config(192).replace(contact_iters=8,
                                          contact_table=False)
    with pytest.warns(UserWarning, match="contact_rebuild > 1"):
        s = prepare_contacts(scenes.box_pile(192, x_aspect=4.0, layers=3,
                                             device="cpu"), cfg)
    return s, cfg


def _rain_guard():
    """24 octahedra pressed into contact, under rain_config's motion
    guard at vel_factor 8 (K = 4): steps 0-2 a scheduled rebuild and two
    refreshes, step 3 a rebuild the guard forces, step 4 a scheduled
    one."""
    arrays = to_numpy(scenes.hull_rain(octahedron_verts(), 24,
                                       device="cpu"))
    arrays["pos"] *= np.float32([0.7, 0.6, 0.7])
    arrays["pos"][:, 1] += 0.3
    cfg = scenes.rain_config(24).replace(contact_rebuild_vel_factor=8.0)
    return prepare_contacts(state_from_arrays(arrays, "cpu"), cfg), cfg


def _packed():
    """16 packed envs with the gated refresh, rebuilt every 4th step."""
    cfg = scenes.packed_env_config(16, 8).replace(contact_rebuild=4)
    return prepare_contacts(scenes.packed_envs(16, 8, device="cpu"),
                            cfg), cfg


def _demo():
    """The reference's demo scene under compat_config (no contacts)."""
    return demo_scene(device="cpu"), compat_config(dt=1.0 / 60.0)


def _pendulums():
    """16 packed pendulums (2 bodies, a pin and a ball joint each)."""
    return packed_pendulums(16)[0], SimConfig(dt=1.0 / 120.0)


PATHS = {"pile": (_pile, 9), "two_kernel": (_two_kernel, 3),
         "rain_guard": (_rain_guard, 5), "packed": (_packed, 6),
         "demo": (_demo, 5), "pendulums": (_pendulums, 5)}


def eager_capture(fn, pool):
    """A capture that records `fn` and runs it at each replay."""
    return SimpleNamespace(replay=fn, pool=lambda: None)


def eager_compose(pred, flag, on_true, on_false):
    """ConditionalGraph's stand-in: `pred`, then one side by the flag."""
    def replay():
        pred.replay()
        (on_true if int(flag[0]) else on_false).replay()
    return SimpleNamespace(replay=replay)


def _assert_same(a, b):
    assert a.step_count_host == b.step_count_host
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


def _loop(s, cfg, n, every):
    samples = []
    for k in range(n):
        s = step(s, cfg)
        if every and (k + 1) % every == 0:
            samples.append((s.pos, s.quat))
    return s, samples


@pytest.mark.parametrize("path", list(PATHS))
def test_device_stepper_matches_step_loop(path):
    """The stepper (eager stand-in for the graphs) against a loop of
    step: every field bit for bit after each sampled step and at the
    end; the caller's state untouched; one capture a branch."""
    make, n = PATHS[path]
    s0, cfg = make()
    before = {f.name: getattr(s0, f.name).clone()
              for f in dataclasses.fields(s0)
              if isinstance(getattr(s0, f.name), torch.Tensor)}
    ref, samples = _loop(s0, cfg, n, 2)
    captures = []

    def capture(fn, pool):
        captures.append(tc.rebuild_branch(stepper.state, cfg))
        return eager_capture(fn, pool)
    stepper = DeviceStepper(s0, cfg, capture=capture, compose=eager_compose)
    got = []
    for k in range(n):
        st = stepper.step()
        if (k + 1) % 2 == 0:
            got.append((st.pos.clone(), st.quat.clone()))
    _assert_same(stepper.state, ref)
    for (p, q), (pr, qr) in zip(got, samples):
        assert torch.equal(p, pr) and torch.equal(q, qr)
    for name, t in before.items():
        assert torch.equal(getattr(s0, name), t), name
    # the GUARDED branch is three captures: the predicate and both steps
    branches = {"pile": 2, "two_kernel": 1, "rain_guard": 4, "packed": 2,
                "demo": 1, "pendulums": 1}
    assert len(captures) == branches[path]


@pytest.mark.parametrize("every", [0, 3], ids=["final", "sampled"])
def test_rollout_matches_step_loop(every):
    """The CPU rollout (a loop) with and without sample_every."""
    s0, cfg = _pile()
    n = 9
    final, traj = rollout(s0, cfg, n, sample_every=every)
    ref, samples = _loop(s0, cfg, n, every)
    _assert_same(final, ref)
    if every:
        assert traj[0].shape == (n // every, 256, 3)
        assert torch.equal(traj[0], torch.stack([p for p, _ in samples]))
        assert torch.equal(traj[1], torch.stack([q for _, q in samples]))
    else:
        assert traj is None
    with pytest.raises(ValueError, match="multiple of sample_every"):
        rollout(s0, cfg, 10, sample_every=3)


@pytest.mark.parametrize("path", ["pile", "rain_guard", "packed"])
def test_schedule_matches_step_branch(path, monkeypatch):
    """rebuild_branch, which the stepper reads before each step, against
    the branch step_with_metrics takes from the same state (a rebuild
    calls solver.contacts._rebuild); on the hull rain an off-schedule
    step is GUARDED, decided by the motion guard's device predicate on
    the velocities after gravity and the velocity integration;
    forced_rebuild makes a step take the branch it names."""
    make, n = PATHS[path]
    s, cfg = make()
    calls = []
    real = tc._rebuild
    monkeypatch.setattr(tc, "_rebuild",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    picked, taken = [], []
    for _ in range(n):
        pick = tc.rebuild_branch(s, cfg)
        if pick == tc.GUARDED:
            assert path == "rain_guard" and s.step_count_host % 4
            pick = bool(tc.guard_fires(integrate_velocities(
                apply_gravity(s, cfg), cfg), cfg))
        picked.append(pick)
        calls.clear()
        s, _ = step_with_metrics(s, cfg)
        taken.append(bool(calls))
    assert picked == taken
    assert picked[0] and not all(picked)
    if path == "rain_guard":
        # the guard rebuilds off the K = 4 schedule
        assert any(p for k, p in enumerate(picked) if k % 4)
    for force in (True, False):
        calls.clear()
        with tc.forced_rebuild(force):
            step_with_metrics(s, cfg)
        assert bool(calls) == force
    s2, c2 = _two_kernel()
    assert tc.rebuild_branch(s2, c2) is None


def test_guarded_tally_counts_the_guard_rebuilds(monkeypatch):
    """The hull rain's GUARDED steps (the warm-up and the replays of the
    stand-in): the device tally that settle() reads holds the steps
    whose guard fired, as many as the loop of step rebuilds off the
    schedule; settle() empties it."""
    s0, cfg = _rain_guard()
    calls = []
    real = tc._rebuild
    monkeypatch.setattr(tc, "_rebuild",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    s, guard = s0, 0
    for _ in range(9):
        calls.clear()
        off = s.step_count_host % 4 != 0
        s = step(s, cfg)
        guard += off and bool(calls)
    stepper = DeviceStepper(s0, cfg, capture=eager_capture,
                            compose=eager_compose)
    for _ in range(9):
        stepper.step()
    assert guard > 0 and stepper.captured == {True, tc.GUARDED}
    assert stepper._pending == 6 and int(stepper._tally) == guard
    stepper.settle()
    assert stepper._pending == 0 and int(stepper._tally) == 0
    assert engine.COUNTED[-1] is cg.solve


def test_refresh_gate_threshold_is_the_f32_tensors():
    """dmb > python_float against dmb > torch.tensor(python_float, f32),
    bit for bit: values at, just above and just below the f32 rounding
    of thresholds whose f32 and f64 values differ, and the gate of 64
    packed envs (4 buckets) moved by different amounts."""
    for thr in (2.0 * 0.01, 2.0 * 0.005, 0.1, 1.0 / 3.0):
        t32 = np.float32(thr)
        vals = np.array([t32, np.nextafter(t32, np.float32(1)),
                         np.nextafter(t32, np.float32(0)), thr, 0.0, 1.0],
                        np.float32)
        dmb = torch.from_numpy(vals)
        old = dmb > torch.tensor(thr, dtype=torch.float32)
        assert torch.equal(dmb > thr, old)
    cfg = scenes.packed_env_config(64, 8)
    s = prepare_contacts(scenes.packed_envs(64, 8, device="cpu"), cfg)
    thr = cfg.contact_rebuild_vel_factor * cfg.penetration_slop
    s = s.replace(pos=s.pos + torch.linspace(
        0, 1.2 * thr, s.num_bodies)[:, None])
    gate = tc.refresh_gate(s, cfg, None)
    old = _old_refresh_gate(s, cfg)
    assert torch.equal(gate, old) and 0 < int(gate.sum()) < gate.numel()


def _old_refresh_gate(st, cfg):
    """refresh_gate as it compared before: against an f32 tensor."""
    from physics_tpu_torch.ops.contact_table import BLOCK, table_shape

    nb = table_shape(st.num_bodies, cfg)[0]
    ref = st.contact_ref
    dp = torch.amax(torch.abs(st.pos - ref[:, 0:3]), dim=1)
    dq2 = torch.minimum(torch.sum((st.quat - ref[:, 3:7]) ** 2, dim=1),
                        torch.sum((st.quat + ref[:, 3:7]) ** 2, dim=1))
    r_body = torch.sqrt(torch.sum(st.shapes.params ** 2, dim=1))
    disp = dp + 2.0 * torch.sqrt(dq2) * r_body
    dmb = torch.amax(torch.nn.functional.pad(
        disp, (0, nb * BLOCK - st.num_bodies)).reshape(nb, BLOCK), dim=1)
    dmb = torch.maximum(dmb, torch.cat([dmb[1:], torch.zeros_like(dmb[:1])]))
    return dmb > torch.tensor(
        cfg.contact_rebuild_vel_factor * cfg.penetration_slop,
        dtype=torch.float32)
