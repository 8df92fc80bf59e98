"""The traffic: the amount of work does not depend on --seed (the reset
schedule, the calls and the resets a call are the same for every seed),
the inputs do (every env draws its own boxes), and the pile's arrays are
the port's scenes.box_pile."""

import json

import numpy as np
import pytest

from portbench.core import scene, traffic
from portbench.scenes import box_pile, packed_envs
from portbench.tests.tiny import ROOT

ENVS = json.load(open(ROOT / "portbench/configs/envs4096x8.json"))["scene"]
MIXES = ["settled16", "reset4", "still32"]


def mix(name):
    return json.load(open(ROOT / "portbench/traffic" / f"{name}.json"))


@pytest.mark.parametrize("name", MIXES)
def test_two_seeds_same_work(name):
    p = dict(ENVS, n_envs=64)
    a = traffic.Schedule(mix(name), p, 5, packed_envs)
    b = traffic.Schedule(mix(name), p, 2**31 + 77, packed_envs)
    assert (a.steps_per_call, a.settle_calls, a.check_steps) == (
        b.steps_per_call, b.settle_calls, b.check_steps)
    for k in range(0, 900, 7):
        assert a.bodies_reset(k) == b.bodies_reset(k)
        if a.resets:
            ia, pa, _ = a.resets_of(k)
            ib, pb, _ = b.resets_of(k)
            assert np.array_equal(ia, ib)
            if len(ia):
                assert not np.array_equal(pa, pb)


def test_reset4_resets_13_or_14_envs_a_call_once_an_episode():
    s = traffic.Schedule(mix("reset4"), ENVS, 3, packed_envs)
    counts = [s.bodies_reset(k) // ENVS["n_bodies"] for k in range(300)]
    assert set(counts) == {13, 14} and sum(counts) == ENVS["n_envs"]
    seen = np.concatenate([s.phase_bodies[p] for p in range(300)])
    assert np.array_equal(np.sort(seen), np.arange(4096 * 8))
    assert s.reset_of(300) == (0, 1) and s.reset_of(299) == (299, 0)


def test_each_env_draws_its_own_boxes():
    p = dict(ENVS, n_envs=32)
    a = packed_envs.make(p, 9)
    pos = a["pos"].reshape(32, 8, 3) - packed_envs.env_offsets(p)
    assert len({pos[e].tobytes() for e in range(32)}) == 32
    assert pos.min(axis=(0, 1)).tolist() >= [-3, 1, -3]
    assert pos.max(axis=(0, 1)).tolist() <= [3, 6, 3]
    b = packed_envs.make(p, 10)
    assert not np.array_equal(a["pos"], b["pos"])
    assert np.array_equal(a["pos"], packed_envs.make(p, 9)["pos"])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_pile_is_the_ports_box_pile(seed):
    from physics_tpu_torch import scenes
    from physics_tpu_torch.state import to_numpy

    conf = json.load(open(ROOT / "portbench/configs/pile4k.json"))["scene"]
    p = dict(conf, n_bodies=256, x_aspect=4.0)
    got = box_pile.make(p, seed)
    want = to_numpy(scenes.box_pile(256, seed=seed, x_aspect=4.0,
                                    device="cpu"))
    for k in ("pos", "quat", "inertia", "mass", "inv_mass"):
        if k == "inv_mass":
            assert np.array_equal(1.0 / got["mass"], want[k])
        else:
            assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["shapes"]["params"], want["shapes.params"])


def test_packed_layout_is_the_ports():
    """With every env drawing random_env(0)'s boxes the benchmark's
    packed scene is scenes.packed_envs's, body e·K + k."""
    import torch

    from physics_tpu_torch import scenes
    from physics_tpu_torch.state import to_numpy

    p = dict(ENVS, n_envs=16)
    base = to_numpy(scenes.random_env(0, 8, device="cpu"))
    want = to_numpy(scenes.packed_envs(16, 8, device="cpu"))
    pos = (base["pos"][None] + packed_envs.env_offsets(p)).reshape(-1, 3)
    assert np.array_equal(pos, want["pos"])
    got = scene.boxes(pos, np.tile(base["quat"], (16, 1)), p)
    for k in ("quat", "inertia", "mass"):
        assert np.array_equal(got[k], want[k]), k
    assert torch.equal(torch.as_tensor(got["shapes"]["params"]),
                       torch.as_tensor(want["shapes.params"]))
