"""The two-kernel box pile as a whole: physics_tpu_torch.engine.
step_with_metrics (kernels' plain versions on the CPU) against
physics_tpu's jitted step (Pallas kernels in interpret mode) under
pile_config with the contact table off, at the test sizes of
tests/test_torch_pair_manifolds.py, each step taken from IDENTICAL
states: the first from the prepared state (empty warm buffers), the
second warm-started from the first. And one step of the unfused table
solve (fuse_prep off, rebuild every step), in its fused-integration
form against the JAX package and in the other two forms against it.

The JAX package on the CPU takes the generic body-major ground contacts
where the port takes the TPU route (slot-major corners), so the two
order the contacts of one rank differently before the rank sort; Jacobi
sweeps do not depend on that order beyond f32 summation, and the stored
warm keys are sorted. Tolerances as in tests/test_torch_slice.py: pos
and quat 2e-4, vel 2e-3 m/s, omega 4e-3 rad/s, the sorted warm impulses
2e-3; contact counts, the overflow counters and the sorted contact keys
identical, with contact_overflow 0 (no cut at capacity, where the order
within a rank would decide which contacts stay).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import configs, dense_pile, jax_arrays
from tests.test_torch_pair_manifolds import np_configs
from tests.test_torch_slice import COUNTERS, TOL

N = 192
LAM_TOL = 2e-3


def _compare(src, dst, jm, cfg_t):
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
    assert int(jm["contact_count"]) > 500
    assert int(jm["contact_overflow"]) == 0
    return ta


def test_prepare_contacts_matches():
    """The generic path's warm buffers: [c] packed keys, c from the
    shapes (ground k·N + pair kk·P, capped at max_contacts, padded to the
    solve tile); contact_rebuild = 4 has no effect here, and both
    packages say so."""
    cfg_j, cfg_t = np_configs(N)
    with pytest.warns(UserWarning, match="no effect"):
        js = jax_arrays(jax_prepare(dense_pile(N), cfg_j))
    with pytest.warns(UserWarning, match="no effect"):
        ts = to_numpy(prepare_contacts(state_from_arrays(
            jax_arrays(dense_pile(N)), "cpu"), cfg_t))
    for k in ("contact_key", "contact_lam", "contact_table",
              "contact_order", "contact_meta", "contact_ref"):
        assert ts[k].shape == js[k].shape, k
        assert np.array_equal(ts[k], js[k]), k
    # uncapped, the same count from the shapes: 4·192 + 4·24·128
    big = dict(max_contacts=0)
    jc = jax_prepare(dense_pile(N), cfg_j.replace(contact_rebuild=1, **big))
    tc = prepare_contacts(state_from_arrays(jax_arrays(dense_pile(N)),
                                            "cpu"),
                          cfg_t.replace(contact_rebuild=1, **big))
    assert tc.contact_key.shape == jnp.shape(jc.contact_key) == (13056,)


@pytest.fixture(scope="module")
def np_run():
    cfg_j, _ = np_configs(N)
    s0 = jax_prepare(dense_pile(N), cfg_j)
    run = jax.jit(jax_step, static_argnums=1)
    s1, m1 = run(s0, cfg_j)
    s2, m2 = run(s1, cfg_j)
    return [(s0, s1, m1), (s1, s2, m2)]


@pytest.mark.parametrize("k", [0, 1], ids=["cold", "warm"])
def test_two_kernel_step_matches(np_run, k):
    src, dst, jm = np_run[k]
    ta = _compare(src, dst, jm, np_configs(N)[1])
    assert ta["contact_key"].shape == (1152,)          # [c] packed keys
    assert (ta["contact_key"] != 0).sum() == int(jm["contact_count"])


def test_unfused_table_step_matches():
    cfg_j, cfg_t = configs(N)
    kw = dict(contact_rebuild=1, fuse_prep=False)
    s0 = jax_prepare(dense_pile(N, seed=3), cfg_j.replace(**kw))
    s1, m1 = jax.jit(jax_step, static_argnums=1)(s0, cfg_j.replace(**kw))
    fused = _compare(s0, s1, m1, cfg_t.replace(**kw))
    # the other two forms: split-impulse update + integrate_positions
    # instead of the solve's epilogue (same math, other rounding)
    for form in (dict(fuse_integrate=False),
                 dict(fuse_prep=True, fuse_integrate=False)):
        ts, tm = step_with_metrics(
            state_from_arrays(jax_arrays(s0), "cpu"),
            cfg_t.replace(**kw).replace(**form))
        ta = to_numpy(ts)
        for key in TOL:
            np.testing.assert_allclose(ta[key], fused[key], rtol=0,
                                       atol=1e-5, err_msg=(form, key))
        assert np.array_equal(ta["contact_key"], fused["contact_key"])
        assert int(tm["contact_count"]) == int(m1["contact_count"])
