"""Gravity and the velocity integration as one entry
(ops/integrator.gravity_and_velocities) and its kernel
(csrc/body_forces.cu).

On the CPU the entry runs its plain version, apply_gravity then
integrate_velocities, whether or not `plain=True` is passed, and
launches nothing: the same bits as the two functions, over gravity
scaled by mass or not, a non-zero gravity offset, the gyroscopic term,
the velocity clamp, static and moving bodies, and gravity alone,
integration alone or both. It refuses compat configs, which the engine
keeps on the plain functions (quirks Q4/Q5). The engine calls it once a
step without joints, twice with them (gravity, the joint solve, then the
integration), never under compat, and once in the motion guard.

The tests marked `cuda` skip without a card. On one they hold the kernel
to the plain version bit for bit (as int32 views: torch.equal counts −0
equal to +0) on the three benchmark scenes' builders at 1,024, 4,096,
4,097 and 32,768 bodies, with non-zero ω, and under each case above, and
count one launch a step without joints and two with them. The device
rollout's replayed steps against eager ones on the pile, the packed envs
and the packed pendulums, with the replays' launch counts (this entry's
among them), are tests/test_torch_cuda.py's
test_rollout_replay_matches_eager. On a GPU machine:

    python -m pytest --noconftest tests/test_torch_body_forces.py

This module imports no JAX.
"""

import numpy as np
import pytest
import torch

import physics_tpu_torch.engine as engine
from physics_tpu_torch import scenes
from physics_tpu_torch.config import SimConfig, compat_config
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.ops.forces import apply_gravity
from physics_tpu_torch.ops.integrator import (
    gravity_and_velocities,
    integrate_velocities,
)
from physics_tpu_torch.scene import demo_scene

from test_torch_geom_table import statics
from test_torch_pendulums import packed_pendulums

FIELDS = ("force", "torque", "vel", "omega")

# config keywords of each case (every state mixes static and moving
# bodies)
CASES = {
    "scaled": {},
    "unscaled": {"gravity_scale_by_mass": False},
    "offset": {"gravity_offset": (0.25, -0.5, 1.5)},
    "unscaled_offset": {"gravity_scale_by_mass": False,
                        "gravity_offset": (0.0, 0.0, 1.5)},
    "gyroscopic": {"gyroscopic": True},
    "clamped": {"max_velocity": 0.75},
}
# (gravity, integrate)
MODES = {"both": (True, True), "gravity": (True, False),
         "integrate": (False, True)}


def kicked(s, seed=0):
    """s with random velocities, angular velocities, forces and torques
    (as the joints leave them), in both signs."""
    rng = np.random.default_rng(seed)

    def draw(scale):
        return torch.tensor(rng.normal(0.0, scale, (s.num_bodies, 3)),
                            dtype=torch.float32, device=s.device)
    return s.replace(vel=draw(1.0), omega=draw(2.0), force=draw(5.0),
                     torque=draw(3.0))


def plain_pair(s, cfg, gravity, integrate):
    if gravity:
        s = apply_gravity(s, cfg)
    if integrate:
        s = integrate_velocities(s, cfg)
    return s


def same_bits(got, ref):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape, name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_route_same_bits(case, mode):
    s = kicked(statics(scenes.box_pile(96, x_aspect=4.0, layers=3,
                                       device="cpu"), seed=3))
    cfg = SimConfig(**CASES[case])
    gravity, integrate = MODES[mode]
    ref = plain_pair(s, cfg, gravity, integrate)
    n0 = gravity_and_velocities.launches
    for plain in (False, True):
        same_bits(gravity_and_velocities(s, cfg, gravity=gravity,
                                         integrate=integrate, plain=plain),
                  ref)
    assert gravity_and_velocities.launches == n0
    # what each case exercises
    moved = ref.vel if integrate else ref.force
    assert not torch.equal(moved, s.vel if integrate else s.force)
    if case == "clamped" and integrate:
        assert float(ref.omega.abs().max()) == 0.75


def test_raises_on_compat_and_on_no_work():
    s = demo_scene(device="cpu")
    for plain in (False, True):
        with pytest.raises(ValueError, match="compat"):
            gravity_and_velocities(s, compat_config(dt=1 / 60), plain=plain)
    with pytest.raises(ValueError, match="neither"):
        gravity_and_velocities(s, SimConfig(), gravity=False,
                               integrate=False)


def _unjointed(device="cpu"):
    cfg = scenes.pile_config(96)
    return engine.prepare_contacts(scenes.box_pile(
        96, x_aspect=4.0, layers=3, device=device), cfg), cfg


def _jointed(device="cpu"):
    return packed_pendulums(8, device=device)[0], SimConfig(dt=1.0 / 120.0)


def _compat(device="cpu"):
    return demo_scene(device=device), compat_config(dt=1.0 / 60.0)


# scene → (state, cfg), the (gravity, integrate) of each call a step
STEPS = {"unjointed": (_unjointed, [(True, True)]),
         "jointed": (_jointed, [(True, False), (False, True)]),
         "compat": (_compat, [])}


@pytest.mark.parametrize("scene", list(STEPS))
def test_step_calls_entry(scene, monkeypatch):
    """step_with_metrics calls the entry once a step without joints, twice
    with them, not under compat; without contacts (the pendulums, the
    demo) the step's velocities are those of the plain functions in
    order."""
    make, want = STEPS[scene]
    s, cfg = make()
    seen = []
    real = engine.gravity_and_velocities

    def spy(state, cfg, gravity=True, integrate=True, plain=False):
        seen.append((gravity, integrate))
        return real(state, cfg, gravity=gravity, integrate=integrate,
                    plain=plain)

    monkeypatch.setattr(engine, "gravity_and_velocities", spy)
    for k in range(2):
        got, _ = step_with_metrics(s, cfg)
        assert seen == want * (k + 1)
        if not (cfg.ground_plane or cfg.pair_collisions):
            ref, _ = engine.solve_joints(apply_gravity(s, cfg), cfg)
            ref = integrate_velocities(ref, cfg)
            for name in ("vel", "omega"):
                assert torch.equal(getattr(got, name), getattr(ref, name))
        s = got


def test_guard_calls_entry(monkeypatch):
    """The motion guard reads the velocities of one entry call."""
    s = kicked(scenes.box_pile(96, x_aspect=4.0, layers=3, device="cpu"))
    cfg = scenes.rain_config(96).replace(contact_rebuild_vel_factor=8.0)
    seen = []
    real = engine.gravity_and_velocities
    monkeypatch.setattr(engine, "gravity_and_velocities",
                        lambda *a, **k: seen.append(k) or real(*a, **k))
    fire = engine._guard(s, cfg)
    assert len(seen) == 1 and bool(fire) == bool(
        engine.guard_fires(integrate_velocities(apply_gravity(s, cfg), cfg),
                           cfg))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _scene(name, dev):
    """(state with non-zero ω, its config) of a benchmark scene's
    builder."""
    if name.startswith("pile"):
        n = int(name[4:])
        return kicked(scenes.box_pile(n, device=dev), 1), \
            scenes.pile_config(n)
    if name == "rain1024":
        return kicked(scenes.mesh_rain(1024, real_assets=False, device=dev),
                      2), scenes.rain_config(1024)
    return kicked(scenes.packed_envs(4096, 8, device=dev), 3), \
        scenes.packed_env_config(4096, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["pile1024", "pile4096", "pile4097",
                                  "rain1024", "packed32768"])
def test_body_forces_kernel_bitwise(dev, name, mode):
    s, cfg = _scene(name, dev)
    gravity, integrate = MODES[mode]
    n0 = gravity_and_velocities.launches
    got = gravity_and_velocities(s, cfg, gravity=gravity,
                                 integrate=integrate)
    assert gravity_and_velocities.launches == n0 + 1
    same_bits(got, plain_pair(s, cfg, gravity, integrate))
    same_bits(gravity_and_velocities(statics(s, seed=4), cfg, gravity=gravity,
                                     integrate=integrate),
              plain_pair(statics(s, seed=4), cfg, gravity, integrate))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_body_forces_kernel_cases(dev, case, mode):
    s = kicked(statics(scenes.box_pile(4097, device=dev), seed=5), 6)
    cfg = SimConfig(**CASES[case])
    gravity, integrate = MODES[mode]
    same_bits(gravity_and_velocities(s, cfg, gravity=gravity,
                                     integrate=integrate),
              plain_pair(s, cfg, gravity, integrate))


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["unjointed", "jointed"])
def test_body_forces_launches_per_step(dev, scene):
    """One launch a step without joints, two with them; the kernel path's
    step against the plain path's."""
    s, cfg = STEPS[scene][0](dev)
    n0 = gravity_and_velocities.launches
    for k in range(3):
        s, _ = step_with_metrics(s, cfg)
        assert gravity_and_velocities.launches == n0 + (k + 1) * len(
            STEPS[scene][1])
