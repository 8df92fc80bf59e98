"""The displacement-gated refresh on the bucketed sweep:
physics_tpu_torch.engine.step_with_metrics (kernels' plain versions on
the CPU) against physics_tpu's jitted step (Pallas kernels in interpret
mode), each step from IDENTICAL states, on a mixed scene shaped like
tests/test_rebuild.py::test_gated_refresh_mixed_scene: a resting grid of
192 boxes and one intruder falling at 8 m/s at the low-x end, so the
intruder's bucket (rank 0 on) fires and the grid's second bucket passes
its persisted block through. The config is that test's (the table
config at dt 1/120, contact_rebuild 8, a 4-sweep refresh, vel_factor 2)
with 2 contacts a pair and 256 lanes a bucket, so the interpreted step
compiles in seconds. Compared: the rebuild step 0 and the gated refresh
step 1.

Tolerances: the whole-step contract of tests/test_torch_slice.py, poses
rounded to 16 significant bits first. Contact keys, the persisted order,
the overflow counters, the contact count and contact_ref (the gate's
fired set) must be identical.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig as JaxConfig
from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu.io.meshes import box_inertia
from physics_tpu.scene import SceneBuilder
from physics_tpu_torch.config import SimConfig as TorchConfig
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.solver.contacts import refresh_gate
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import bf16_pair_exact, jax_arrays

TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 4e-3}
EXACT = ("contact_key", "contact_order", "contact_meta", "contact_ref",
         "step_count")
COUNTERS = ("contact_count", "pair_overflow", "contact_overflow",
            "band_overflow")
CFG = JaxConfig(
    ground_plane=True, pair_collisions=True, boxes_only=True,
    broadphase="sweep", sweep_window=12, pair_buckets=True,
    bucket_block=128, contact_solver="pallas_banded", contact_table=True,
    contact_iters=8, max_contacts=1024, fuse_prep=True, dt=1.0 / 120.0,
    contact_rebuild=8, contact_refresh_iters=4,
    contact_rebuild_vel_factor=2.0, max_contacts_per_pair=2,
    bucket_cap=256)


def _rounded(s):
    return s.replace(pos=jnp.asarray(bf16_pair_exact(s.pos)),
                     quat=jnp.asarray(bf16_pair_exact(s.quat)))


def _scene():
    b = SceneBuilder()
    for k in range(192):
        x, z = k % 24, k // 24
        i = b.add_body(pos=(x * 1.25, 0.5, z * 1.25),
                       inertia=box_inertia((0.5,) * 3, 1.0))
        b.set_box(i, (0.5,) * 3, friction=0.5)
    i = b.add_body(pos=(-1.5, 3.0, 2.0), inertia=box_inertia((0.5,) * 3, 1.0))
    b.set_box(i, (0.5,) * 3, friction=0.5)
    s = b.build()
    return s.replace(vel=s.vel.at[192, 1].set(-8.0))


@pytest.fixture(scope="module")
def jax_run():
    s0 = _rounded(jax_prepare(_scene(), CFG))
    run = jax.jit(jax_step, static_argnums=1)
    s1, m1 = run(s0, CFG)
    s1 = _rounded(s1)
    s2, m2 = run(s1, CFG)
    return {"rebuild": (s0, s1, m1), "refresh": (s1, s2, m2)}


def _torch_cfg():
    return TorchConfig(**dataclasses.asdict(CFG))


def test_gate_is_mixed(jax_run):
    ts = state_from_arrays(jax_arrays(jax_run["refresh"][0]), "cpu")
    assert refresh_gate(ts, _torch_cfg(),
                        ts.contact_order).tolist() == [True, False]


@pytest.mark.parametrize("which", ["rebuild", "refresh"])
def test_step_matches(jax_run, which):
    src, dst, jm = jax_run[which]
    ts, tm = step_with_metrics(state_from_arrays(jax_arrays(src), "cpu"),
                               _torch_cfg())
    ja, ta = jax_arrays(dst), to_numpy(ts)
    for key, tol in TOL.items():
        np.testing.assert_allclose(ta[key], ja[key], rtol=0, atol=tol,
                                   err_msg=key)
    for key in EXACT:
        assert np.array_equal(ta[key], ja[key]), key
    for key in COUNTERS:
        assert int(tm[key]) == int(jm[key]), key
    # the rebuild step's resting grid has not sunk yet (no active
    # contact), but its table already holds the grid's ground slots
    assert int((ja["contact_key"][0] >= 0).sum()) > 200
    if which == "refresh":
        assert int(jm["contact_count"]) > 200
    for r in (9, 10, 11, 12, 13, 14, 15):
        assert np.array_equal(ta["contact_table"][r],
                              ja["contact_table"][r]), r
