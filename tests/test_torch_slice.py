"""The ported step as a whole: physics_tpu_torch.engine.step_with_metrics
(kernels' plain versions on the CPU) against physics_tpu's jitted step
(Pallas kernels in interpret mode), each step taken from IDENTICAL states
— the JAX run's state converted with state_from_arrays. The config is
the 4k pile's (anchored rebuild every 4th step, 4-sweep refresh) on a
contact-rich two-bucket pile.

Tolerances (one step, dt = 1/60): the JAX step reads geometry through
hi/lo bf16 splits (2⁻¹⁷ relative, ~1e-4 m at x ≈ 16 m), which shifts
near-parallel edge-edge contact points by up to a few mm, and near-zero
sliding speeds can flip a friction clamp's sign in a sweep; pos and quat
are held to 2e-4, vel to 2e-3 m/s and omega to 4e-3 rad/s (measured
2.4e-5, 1.8e-5, 2.5e-4, 5.7e-4 on the rebuild step). Contact sets,
counts and overflow counters must be identical.
"""

import numpy as np
import pytest

import jax

from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import configs, dense_pile, jax_arrays

N = 192
TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 4e-3}
EXACT = ("contact_key", "contact_order", "contact_meta", "step_count")
COUNTERS = ("contact_count", "pair_overflow", "contact_overflow",
            "band_overflow")


@pytest.fixture(scope="module")
def jax_run():
    """States before and after a rebuild step (step 0) and a refresh step
    (step 1) of the JAX package, with their metrics."""
    cfg_j, _ = configs(N)
    s0 = jax_prepare(dense_pile(N), cfg_j)
    run = jax.jit(jax_step, static_argnums=1)
    s1, m1 = run(s0, cfg_j)
    s2, m2 = run(s1, cfg_j)
    return {"rebuild": (s0, s1, m1), "refresh": (s1, s2, m2)}


@pytest.mark.parametrize("which", ["rebuild", "refresh"])
def test_step_matches(jax_run, which):
    src, dst, jm = jax_run[which]
    _, cfg_t = configs(N)
    ts, tm = step_with_metrics(
        state_from_arrays(jax_arrays(src), "cpu"), cfg_t)
    ja, ta = jax_arrays(dst), to_numpy(ts)
    assert ts.step_count_host == int(ja["step_count"])
    for k, tol in TOL.items():
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=tol,
                                   err_msg=k)
    for k in EXACT:
        assert np.array_equal(ta[k], ja[k]), k
    for k in COUNTERS:
        assert int(tm[k]) == int(jm[k]), k
    assert int(jm["contact_count"]) > 500
    # the persisted table carries the same contacts (activity, keys and
    # ranks are integer-valued rows)
    for r in (9, 10, 11, 12, 13, 14, 15):
        assert np.array_equal(ta["contact_table"][r],
                              ja["contact_table"][r]), r
    np.testing.assert_allclose(float(tm["max_penetration"]),
                               float(jm["max_penetration"]), atol=1e-3)
