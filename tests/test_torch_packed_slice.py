"""The packed-environments slice: physics_tpu_torch.envs against
physics_tpu.envs (pack and unpack, exact), and the packed step as a
whole — physics_tpu_torch.engine.step_with_metrics (kernels' plain
versions on the CPU) against physics_tpu's jitted step (Pallas kernels in
interpret mode), each step from IDENTICAL states: a rebuild step (the
env_blocks table, identity order) and the gated refresh step after it,
on 32 envs of 8 boxes (two buckets) under the packed configuration with
its capacities cut (2 contacts a pair, 256 lanes and slots a bucket) so
the interpreted step compiles in seconds. Env 0's bodies fall at 3 m/s,
so its bucket's gate fires, while the second bucket's envs hang apart
and at rest, so it passes through.

Tolerances: the whole-step contract of tests/test_torch_slice.py (pos
and quat 2e-4, vel 2e-3 m/s, omega 4e-3 rad/s), poses rounded to 16
significant bits first (the JAX table kernel reads them through a hi/lo
bf16 split). Contact keys, the persisted order, the overflow counters,
the contact count and contact_ref (so the gate's fired set) must be
identical.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig as JaxConfig
from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu.envs import pack_envs as jax_pack
from physics_tpu.envs import unpack_envs as jax_unpack
from physics_tpu.io.meshes import box_inertia
from physics_tpu.scene import SceneBuilder
from physics_tpu.scenes import random_env
from physics_tpu_torch import envs, scenes as tscenes
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.solver.contacts import refresh_gate, table_path
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import bf16_pair_exact, jax_arrays

E, K = 32, 8
TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 4e-3}
EXACT = ("contact_key", "contact_order", "contact_meta", "contact_ref",
         "step_count")
COUNTERS = ("contact_count", "pair_overflow", "contact_overflow",
            "band_overflow")


def _jax_batched(e=E, k=K):
    base = random_env(0, k)
    offsets = np.random.default_rng(1).uniform(-1, 1, (e, 1, 3))
    return jax.vmap(lambda o: base.replace(pos=base.pos + o))(
        jnp.asarray(offsets.astype(np.float32)))


def test_packed_env_config_matches_the_bench():
    """scenes.packed_env_config is bench.py's bench_batched_envs config."""
    e, k = 4096, 8
    bench = JaxConfig(
        compat=False, ground_plane=True, pair_collisions=True,
        contact_iters=8, dt=1.0 / 60.0, boxes_only=True,
        broadphase="env_blocks", env_block_size=k,
        contact_solver="pallas_banded", max_contacts=48 * e,
        contact_table=True, bp_inkernel=True, bucket_block=128,
        z_bf16=True, fuse_prep=True, fuse_integrate=True,
        contact_rebuild=32, contact_refresh_iters=4,
        contact_rebuild_vel_factor=2.0)
    assert dataclasses.asdict(tscenes.packed_env_config(e, k)) == \
        dataclasses.asdict(bench)


def test_pack_and_unpack_match():
    """The bench's packed scene: port (offset_envs + pack_envs, the
    packed_envs scene) and JAX (vmap + pack_envs) identical field by
    field, and unpack_envs of both."""
    jp = jax_pack(_jax_batched())
    tp = tscenes.packed_envs(E, K, device="cpu")
    ja, ta = jax_arrays(jp), to_numpy(tp)
    assert sorted(ta) == sorted(ja)
    for key in ja:
        assert ta[key].dtype == ja[key].dtype, key
        assert np.array_equal(ta[key], ja[key]), key
    ju, tu = jax_arrays(jax_unpack(jp, E)), to_numpy(envs.unpack_envs(tp, E))
    for key in ju:
        assert np.array_equal(tu[key], ju[key]), key


def test_pack_offsets_joint_body_ids():
    """Joints pack with their body ids offset by e·K (world −1 kept): a
    batch of 3 envs of 2 bodies and 2 joints, as the reference's
    jointed packed test builds it, through the batched arrays."""
    b = SceneBuilder()
    i0 = b.add_body(pos=(1.0, 0.0, 0.0), inertia=box_inertia((0.5,) * 3, 1.0))
    b.fix_to_point(i0, (0.0, 0.0, 0.0))
    i1 = b.add_body(pos=(1.0, 2.0, 0.0), inertia=box_inertia((0.3,) * 3, 1.0))
    b.ball_joint(i0, i1, anchor_a=(0, 1, 0), anchor_b=(0, -1, 0))
    base = b.build()
    offs = np.random.default_rng(2).uniform(-0.1, 0.1, (3, 1, 3))
    batched = jax.vmap(lambda o: base.replace(pos=base.pos + o))(
        jnp.asarray(offs.astype(np.float32)))
    ja = jax_arrays(jax_pack(batched))
    ta = to_numpy(envs.pack_envs(state_from_arrays(jax_arrays(batched),
                                                   "cpu")))
    assert ta["joints.body_a"].shape == (6,)
    for key in ja:
        assert np.array_equal(ta[key], ja[key]), key


def _rounded(s):
    return s.replace(pos=jnp.asarray(bf16_pair_exact(s.pos)),
                     quat=jnp.asarray(bf16_pair_exact(s.quat)))


@pytest.fixture(scope="module")
def jax_run():
    """The packed configuration at cut capacities (both packages), and
    the JAX states before and after the rebuild step 0 and the gated
    refresh step 1, with their metrics."""
    cfg_t = tscenes.packed_env_config(E, K).replace(
        max_contacts_per_pair=2, bucket_cap=256, bucket_ccap=256)
    cfg_j = JaxConfig(**dataclasses.asdict(cfg_t)).replace(z_bf16=False)
    s = jax_pack(_jax_batched())
    vel = np.asarray(s.vel).copy()
    vel[:K, 1] = -3.0                 # env 0 falls fast
    pos = np.asarray(s.pos).copy()    # bucket 1: apart, in the air
    i = np.arange(128)
    pos[128:] = np.stack([(i % 16) * 2.0, np.full(128, 10.0),
                          (i // 16) * 2.0], axis=1)
    s0 = _rounded(jax_prepare(s.replace(vel=jnp.asarray(vel),
                                        pos=jnp.asarray(pos)), cfg_j))
    run = jax.jit(jax_step, static_argnums=1)
    s1, m1 = run(s0, cfg_j)
    s1 = _rounded(s1)
    s2, m2 = run(s1, cfg_j)
    return cfg_t, {"rebuild": (s0, s1, m1), "refresh": (s1, s2, m2)}


def test_refresh_gate_is_mixed(jax_run):
    cfg_t, run = jax_run
    ts = state_from_arrays(jax_arrays(run["refresh"][0]), "cpu")
    assert table_path(ts, cfg_t)
    assert refresh_gate(ts, cfg_t, None).tolist() == [True, False]


@pytest.mark.parametrize("which", ["rebuild", "refresh"])
def test_step_matches(jax_run, which):
    cfg_t, run = jax_run
    src, dst, jm = run[which]
    ts, tm = step_with_metrics(state_from_arrays(jax_arrays(src), "cpu"),
                               cfg_t)
    ja, ta = jax_arrays(dst), to_numpy(ts)
    for key, tol in TOL.items():
        np.testing.assert_allclose(ta[key], ja[key], rtol=0, atol=tol,
                                   err_msg=key)
    for key in EXACT:
        assert np.array_equal(ta[key], ja[key]), key
    for key in COUNTERS:
        assert int(tm[key]) == int(jm[key]), key
    assert int(jm["contact_count"]) > 20
    for r in (9, 10, 11, 12, 13, 14, 15):
        assert np.array_equal(ta["contact_table"][r],
                              ja["contact_table"][r]), r
    # the identity order persists; env 0's bodies took a fresh ref only
    # where their bucket fired
    assert np.array_equal(ta["contact_order"], np.arange(E * K))
    if which == "refresh":
        pose = np.concatenate([ja_src(run, which, "pos"),
                               ja_src(run, which, "quat")], axis=1)
        fired = np.all(ta["contact_ref"] == pose, axis=1)
        assert fired[:128].all() and not fired[128:].all()


def ja_src(run, which, key):
    return np.asarray(getattr(run[which][0], key))
