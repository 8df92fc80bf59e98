"""The reference against the program on the CPU: the frozen copy of the
plain box step (portbench/reference) gives the port's plain step bit for
bit, from the benchmark's own scene arrays, on the pile and the packed
envs (rebuild, refresh and gated refresh steps, and a reset)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import box_step as ref
from portbench.scenes import box_pile, packed_envs
from portbench.reference.state import Config

HERE = Path(__file__).resolve().parent.parent


def small(name):
    conf = json.load(open(HERE / "configs" / f"{name}.json"))
    if name == "pile4k":
        p = dict(conf["scene"], n_bodies=256, x_aspect=4.0)
        from physics_tpu_torch import scenes
        cfg = scenes.pile_config(256).replace(contact_iters=8)
    else:
        p = dict(conf["scene"], n_envs=16)
        from physics_tpu_torch import scenes
        cfg = scenes.packed_env_config(16, 8)
    return p, cfg


def sim_of(cfg):
    import dataclasses
    return Config(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name,steps", [("pile4k", 9), ("envs4096x8", 35)])
def test_reference_steps_as_the_port(name, steps):
    from physics_tpu_torch.engine import step as port_step
    from portbench.core.program import build_state

    p, cfg = small(name)
    arrays = (box_pile if name == "pile4k" else packed_envs).make(p, 11)
    st = build_state(arrays, cfg, "cpu")
    rs = ref.initial_state(arrays, sim_of(cfg), "cpu")
    kinds = set()
    for k in range(steps):
        if name == "envs4096x8" and k == 33:
            idx = torch.arange(8, 16)
            pos, quat = packed_envs.env_draws(p, 11, 1)
            pn = torch.as_tensor(pos.reshape(-1, 3))[idx]
            qn = torch.as_tensor(quat.reshape(-1, 4))[idx]
            st.pos[idx], st.quat[idx] = pn, qn
            st.vel[idx], st.omega[idx] = 0.0, 0.0
            rs = ref.reset_bodies(rs, idx, pn, qn)
        st = port_step(st, cfg)
        rs = ref.step(rs, sim_of(cfg),
                      on_step=lambda s_, c_, s: kinds.add(
                          (s["rebuild"], s["gate"] is not None)))
        for f in ("pos", "quat", "vel", "omega", "contact_key",
                  "contact_lam", "contact_table", "contact_ref"):
            assert torch.equal(getattr(st, f), getattr(rs, f)), (k, f)
    want = {(True, False), (False, name == "envs4096x8")}
    assert kinds == want
