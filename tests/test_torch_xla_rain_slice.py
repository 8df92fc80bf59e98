"""The generic hull path as a whole (scenes.rain_xla_config: the flat
sweep compacted to 12N candidates, the OBB prefilter to 4N lanes, the
hull vertices on the ground and the slot-major hull manifolds, the
banded solve 2.5 with 2.6 in its sweep 0): physics_tpu_torch.engine.
step_with_metrics (plain versions on the CPU) against physics_tpu's
jitted step (Pallas kernels in interpret mode, z_bf16 off), each step
from IDENTICAL states, after the pattern of tests/test_torch_np_slice.py.

  - prepare_contacts: the warm buffers of both packages, same shapes,
    for the 32-hull rain and the 3-type 16-hull rain, also with the
    prefilter off, uncapped, wider type-pair segments and the bucketed
    sweep's lanes;
  - mesh_rain(32) settled 6 steps by the port: a cold step (zeroed warm
    buffers) and a warm step (the first step's keys and λ);
  - mesh_rain_mixed(16, n_types=3) settled 26 steps: one warm step (the
    type-pair-segmented prefilter and manifolds, 7 lanes a segment, which
    drop a survivor there: prefilter_overflow 1);
  - the port's own cross-check, as tests/test_hull_table.py:37 does for
    the JAX package: on the 32-hull rain after 2 steps this path's active
    contact keys equal the hull contact table's (plain version, under
    rain_config with the anchoring and fusion off), depths within 1e-4;
  - the path under shard= raises, naming ROADMAP item 1.15.

Both packages lay the contacts out in the same slot-major order, so the
solves see the same list. Tolerances as in tests/test_torch_slice.py:
pos and quat 2e-4, vel 2e-3 m/s, omega 4e-3 rad/s, the sorted warm
impulses 2e-3; the sorted contact keys and every counter (contact_count,
pair_overflow, prefilter_overflow, contact_overflow, band_overflow)
identical.
"""

import numpy as np
import pytest
import torch

import jax

from physics_tpu import scenes as jscenes
from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.ops.broadphase import (
    body_aabbs,
    pair_candidates,
    sweep_order,
)
from physics_tpu_torch.ops.contact_table import (
    CT_ACT,
    CT_D,
    table_keys_scalar,
    unified_geom,
)
from physics_tpu_torch.ops.hull_table import (
    bucket_hull_contact_table,
    hull_slots,
)
from physics_tpu_torch.parallel.collectives import Shard
from physics_tpu_torch.solver.contacts import (
    banded_hulls_path,
    hull_contact_list,
    resolve_contacts,
)
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import jax_arrays
from tests.test_torch_hull_table import jax_state_like
from tests.test_torch_slice import TOL

LAM_TOL = 2e-3
COUNTERS = ("contact_count", "pair_overflow", "prefilter_overflow",
            "contact_overflow", "band_overflow")
SCENES = {"rain32": (32, 1, 6), "mixed16": (16, 3, 26)}


def jax_scene(n, types):
    if types == 1:
        return jscenes.mesh_rain(n, real_assets=False)
    return jscenes.mesh_rain_mixed(n, real_assets=False, n_types=types)


def settled(name):
    """(JAX state, port state, port config, JAX config): the scene
    prepared and stepped by the port, the same arrays in both packages."""
    n, types, steps = SCENES[name]
    js = jax_scene(n, types)
    cfg_t = tscenes.rain_xla_config(n)
    cfg_j = jscenes.rain_xla_config(n).replace(z_bf16=False)
    ts = prepare_contacts(state_from_arrays(jax_arrays(js), "cpu"), cfg_t)
    for _ in range(steps):
        ts, _ = step_with_metrics(ts, cfg_t)
    arrays = to_numpy(ts)
    return (jax_state_like(js, arrays), state_from_arrays(arrays, "cpu"),
            cfg_t, cfg_j)


# the warm buffers' capacity from the shapes, against the JAX package's
# eval_shape: the configs as they are, with the prefilter off, uncapped,
# the 3-type prefilter's segments wider, and the bucketed sweep's lanes
# (rain_config with the hull table off takes this path too)
CAPACITY = {"rain32": (32, 1, {}), "mixed16": (16, 3, {}),
            "no_prefilter": (32, 1, dict(hull_prefilter_cap=0)),
            "uncapped": (32, 1, dict(max_contacts=0)),
            "mixed_wide": (16, 3, dict(hull_prefilter_cap=9 * 40)),
            "bucketed": (32, 1, dict(pair_buckets=True, bucket_block=128,
                                     bucket_cap2=512))}


@pytest.mark.parametrize("name", list(CAPACITY))
def test_prepare_contacts_matches(name):
    n, types, over = CAPACITY[name]
    js = jax_prepare(jax_scene(n, types), jscenes.rain_xla_config(n)
                     .replace(z_bf16=False, **over))
    cfg = tscenes.rain_xla_config(n).replace(**over)
    ts = prepare_contacts(
        state_from_arrays(jax_arrays(jax_scene(n, types)), "cpu"), cfg)
    assert banded_hulls_path(ts, cfg)
    ja, ta = jax_arrays(js), to_numpy(ts)
    for k in ("contact_key", "contact_lam", "contact_table",
              "contact_order", "contact_meta", "contact_ref"):
        assert ta[k].shape == ja[k].shape, k
        assert np.array_equal(ta[k], ja[k]), k
    assert ta["contact_key"].ndim == 1          # [c] packed keys


@pytest.fixture(scope="module")
def jax_run():
    """{case: (source state, JAX state after one step, JAX metrics, port
    config)}."""
    run = jax.jit(jax_step, static_argnums=1)
    js, _, cfg_t, cfg_j = settled("rain32")
    cold = js.replace(contact_key=js.contact_key * 0,
                      contact_lam=js.contact_lam * 0)
    s1, m1 = run(cold, cfg_j)
    s2, m2 = run(s1, cfg_j)
    out = {"cold": (cold, s1, m1, cfg_t), "warm": (s1, s2, m2, cfg_t)}
    js, _, cfg_t, cfg_j = settled("mixed16")
    s1, m1 = run(js, cfg_j)
    out["mixed"] = (js, s1, m1, cfg_t)
    return out


@pytest.mark.parametrize("case", ["cold", "warm", "mixed"])
def test_step_matches(jax_run, case):
    src, dst, jm, cfg_t = jax_run[case]
    ts, tm = step_with_metrics(state_from_arrays(jax_arrays(src), "cpu"),
                               cfg_t)
    ja, ta = jax_arrays(dst), to_numpy(ts)
    for k, tol in TOL.items():
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert np.array_equal(ta["contact_key"], ja["contact_key"])
    np.testing.assert_allclose(ta["contact_lam"], ja["contact_lam"], rtol=0,
                               atol=LAM_TOL)
    for k in COUNTERS:
        assert int(tm[k]) == int(jm[k]), k
    assert int(jm["contact_count"]) > (15 if case == "mixed" else 40)
    if case == "mixed":
        assert int(jm["prefilter_overflow"]) > 0
    assert (ta["contact_key"] != 0).sum() == int(jm["contact_count"])


def test_contact_set_matches_hull_table():
    """This path's active contacts (keys, depths) against the hull
    contact table's on one state, with every counter of both 0."""
    n = 32
    cfg_x = tscenes.rain_xla_config(n)
    cfg_t = tscenes.rain_config(n).replace(
        bucket_cap2=256, contact_rebuild=1, contact_refresh_iters=0,
        fuse_prep=False, fuse_integrate=False)
    st = prepare_contacts(tscenes.mesh_rain(n, real_assets=False,
                                            device="cpu"), cfg_x)
    for _ in range(2):
        st, _ = step_with_metrics(st, cfg_x)
    ca, _, _, _, _, _, counters = hull_contact_list(st, cfg_x)
    assert counters.keys() == {"pair_overflow", "prefilter_overflow"}
    assert all(int(v) == 0 for v in counters.values())
    act = ca.active & (ca.key != 0)
    ka, da = ca.key[act], ca.depth[act]
    assert ka.numel() > 40 and ka.unique().numel() == ka.numel()

    order = sweep_order(st, body_aabbs(st))
    table, meta, _ = bucket_hull_contact_table(
        st, pair_candidates(st, cfg_t), cfg_t,
        geom=unified_geom(st, cfg_t, order, hulls=True))
    kb = table_keys_scalar(table, n, hull_slots(st.hulls),
                           st.hulls.verts.shape[1])
    act_b = kb != 0
    assert torch.equal(act_b, table[CT_ACT] > 0)
    per_bucket = meta[0].reshape(-1, 128)
    assert int(per_bucket[:, 0].sum()) == 0      # contacts dropped
    assert int(per_bucket[:, 2].sum()) == 0      # prefilter survivors dropped
    kb, db = kb[act_b], table[CT_D][act_b]
    assert sorted(ka.tolist()) == sorted(kb.tolist())
    ia, ib = torch.argsort(ka), torch.argsort(kb)
    np.testing.assert_allclose(da[ia].numpy(), db[ib].numpy(), rtol=0,
                               atol=1e-4)


def test_sharded_step_refused():
    """Under shard= the JAX package skips the prefilter (and raises for
    several hull types): the port refuses the path, naming the item."""
    cfg = tscenes.rain_xla_config(16)
    st = prepare_contacts(tscenes.mesh_rain(16, real_assets=False,
                                            device="cpu"), cfg)
    with pytest.raises(NotImplementedError, match="1.15"):
        resolve_contacts(st, cfg, shard=Shard(None, 0, 2))
