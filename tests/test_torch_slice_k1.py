"""The ported step with contact_rebuild = 1 (rebuild every step, 16-row
table without anchors, warm start by key match on every step) against
physics_tpu's jitted step, each step from identical states; the second
step exercises the warm start from the first. Tolerances as in
tests/test_torch_slice.py."""

import numpy as np
import pytest

import jax

from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import configs, dense_pile, jax_arrays
from tests.test_torch_slice import COUNTERS, TOL

N = 192


@pytest.fixture(scope="module")
def jax_run():
    cfg_j, _ = configs(N)
    cfg_j = cfg_j.replace(contact_rebuild=1)
    s0 = jax_prepare(dense_pile(N, seed=2), cfg_j)
    run = jax.jit(jax_step, static_argnums=1)
    s1, m1 = run(s0, cfg_j)
    s2, m2 = run(s1, cfg_j)
    return [(s0, s1, m1), (s1, s2, m2)]


@pytest.mark.parametrize("k", [0, 1])
def test_step_matches_k1(jax_run, k):
    src, dst, jm = jax_run[k]
    cfg_t = configs(N)[1].replace(contact_rebuild=1)
    ts, tm = step_with_metrics(
        state_from_arrays(jax_arrays(src), "cpu"), cfg_t)
    ja, ta = jax_arrays(dst), to_numpy(ts)
    assert ta["contact_table"].shape == (0, 0)       # nothing persisted
    for key, tol in TOL.items():
        np.testing.assert_allclose(ta[key], ja[key], rtol=0, atol=tol,
                                   err_msg=key)
    assert np.array_equal(ta["contact_key"], ja["contact_key"])
    for key in COUNTERS:
        assert int(tm[key]) == int(jm[key]), key
    assert int(jm["contact_count"]) > 500
