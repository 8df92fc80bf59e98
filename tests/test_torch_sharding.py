"""The row-sharded step: physics_tpu_torch.engine.step_with_metrics with
a shard (what parallel.sharding.row_sharded_step runs) on 2 ranks (torch.distributed over gloo, spawned
processes on this CPU, kernels' plain versions) against the JAX package's
row-sharded step on a 2-device CPU mesh (Pallas kernels in interpret
mode), for one warm step of the two-bucket box pile under the pile
config; and the sharded rain (256 hulls) and two-kernel pile against the
port's own unsharded step, which the other test files hold against the
JAX package.

The JAX side runs the body of its row_sharded_step (step_with_metrics
with shard= inside shard_map) with the metrics as a second output. Its
config turns fuse_integrate off: under shard= the JAX package's solve has
no integration epilogue, yet its engine still skips the position
integration whenever fuse_integrate is set, so its sharded step would
leave positions unmoved by velocity. The port ignores fuse_integrate
under a shard (engine.step_with_metrics), so its config is the pile
config as it is.

Inputs are rounded to 16 significant bits (positions, orientations,
velocities and the warm impulses), which the JAX kernels' hi/lo bf16
split reads exactly. Then the contacts, their table-aligned keys and the
counters must be identical on both sides, pos, quat and vel within 1e-4
and omega within 3e-4 (the sweeps' deltas are summed in different
orders, and the split still rounds the rotations derived from the
quaternions and the scattered deltas by about 2⁻¹⁷; a contact point
moved by that rounding turns its impulse's torque arm, which shows most
in omega: measured 1.1e-4 on one body). Every rank's state must be
bitwise equal to rank 0's. The unsharded comparisons differ only in
summation order: the same tolerances.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu.parallel.sharding import make_mesh
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.parallel.sharding import launch, row_sharded_step
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import (
    bf16_pair_exact,
    configs,
    dense_pile,
    jax_arrays,
)

N = 256
RANKS = 2
ATOL = {"pos": 1e-4, "quat": 1e-4, "vel": 1e-4, "omega": 3e-4}
ROUNDED = ("pos", "quat", "vel", "omega", "contact_lam")
COUNTERS = ("contact_count", "pair_overflow", "contact_overflow",
            "band_overflow")


def _port_configs():
    cfg = tscenes.pile_config(N).replace(contact_iters=8)
    return {"pile": cfg,
            "two_kernel": cfg.replace(contact_table=False),
            "rain": tscenes.rain_config(N)}


def _rank(shard, jobs):
    """One rank: each (name, arrays) job stepped once by step_with_metrics
    with the rank's shard; returns {name: (state arrays, counters)}, and
    under "entry" the pile's step through row_sharded_step."""
    torch.set_num_threads(1)
    cfgs = _port_configs()
    out = {}
    for name, arrays in jobs:
        s = state_from_arrays(arrays, "cpu")
        s1, m = step_with_metrics(s, cfgs[name], shard=shard)
        out[name] = (to_numpy(s1), {k: int(m[k]) for k in COUNTERS})
        if name == "pile":
            out["entry"] = to_numpy(row_sharded_step(cfgs[name])(s))
    return out


def _warm_port_state(name):
    """A port scene with live warm buffers: prepared, one unsharded
    step."""
    cfg = _port_configs()[name]
    if name == "rain":
        s = tscenes.mesh_rain(N, real_assets=False, device="cpu")
    else:
        s = state_from_arrays(jax_arrays(dense_pile(N)), "cpu")
    s = prepare_contacts(s, cfg)
    s, _ = step_with_metrics(s, cfg)
    return to_numpy(s)


@pytest.fixture(scope="module")
def runs():
    cfg_j = configs(N)[0].replace(fuse_integrate=False)
    mesh = make_mesh([RANKS], ["row"])

    @jax.jit
    def jstep(s):
        return shard_map(partial(jax_step, cfg=cfg_j, shard=("row", RANKS)),
                         mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(s)

    s1, _ = jstep(jax_prepare(dense_pile(N), cfg_j))       # cold step
    a1 = jax_arrays(s1)
    for k in ROUNDED:
        a1[k] = bf16_pair_exact(a1[k])
    s1 = s1.replace(**{k: jnp.asarray(a1[k]) for k in ROUNDED})
    j2, jm = jstep(s1)                                       # warm step
    jobs = [("pile", a1)] + [(name, _warm_port_state(name))
                             for name in ("rain", "two_kernel")]
    ranks = launch(_rank, RANKS, (jobs,))
    return (jax_arrays(j2), {k: int(jm[k]) for k in COUNTERS}), jobs, ranks


def _close(got, ref):
    for k, tol in ATOL.items():
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["pile", "rain", "two_kernel"])
def test_ranks_bitwise_equal(runs, name):
    _, _, ranks = runs
    s0, m0 = ranks[0][name]
    for r in range(1, RANKS):
        s, m = ranks[r][name]
        assert m == m0
        for k in s0:
            assert np.array_equal(s[k], s0[k]), (r, k)


def test_row_sharded_step_is_the_sharded_step(runs):
    _, _, ranks = runs
    for r in range(RANKS):
        got, ref = ranks[r]["entry"], ranks[r]["pile"][0]
        for k in ref:
            assert np.array_equal(got[k], ref[k]), (r, k)


def test_sharded_pile_matches_jax(runs):
    (ja, jm), _, ranks = runs
    ta, tm = ranks[0]["pile"]
    assert tm == jm
    assert jm["contact_count"] > 300
    assert np.array_equal(ta["contact_key"], ja["contact_key"])
    assert ta["step_count"] == ja["step_count"]
    _close(ta, ja)


@pytest.mark.parametrize("name", ["rain", "two_kernel"])
def test_sharded_matches_unsharded(runs, name):
    _, jobs, ranks = runs
    arrays = dict(jobs)[name]
    cfg = _port_configs()[name].replace(fuse_prep=False, fuse_integrate=False,
                                        contact_rebuild=1)
    s, m = step_with_metrics(state_from_arrays(arrays, "cpu"), cfg)
    ta, tm = ranks[0][name]
    assert tm == {k: int(m[k]) for k in COUNTERS}
    assert tm["contact_count"] > 200
    ref = to_numpy(s)
    assert np.array_equal(ta["contact_key"], ref["contact_key"])
    _close(ta, ref)
