"""The hull rain step as a whole: physics_tpu_torch.engine.step_with_metrics
(kernels' plain versions on the CPU) against physics_tpu's jitted step
(Pallas kernels in interpret mode), each step taken from IDENTICAL states
— the JAX run's state converted with state_from_arrays — under
rain_config (hull contact table, anchored rebuild every 4th step, 4-sweep
refresh) on a two-bucket rain of 192 bevelled cubes. The rebuild step is
step 4 and the refresh step step 5, so the warm start is live.

Inputs: the JAX hull kernel reads geometry through hi/lo bf16 splits
(16 significant bits). From raw states those reads move contact depths
and edge-edge points by about 2⁻¹⁷ of the coordinates, and in this
falling, colliding rain that moved velocities by up to 0.03 m/s in one
step (measured). So pos and quat of each starting state are rounded to
16 significant bits, for both packages, as the table test rounds its
geometry.

Tolerances (one step, dt = 1/60), the whole-step contract of the box
slice: pos and quat 2e-4, vel 2e-3 m/s, omega 4e-3 rad/s (measured
4.8e-7, 3.6e-7, 1.7e-6 and 2.6e-6 on the rebuild step). Contact keys,
the rank order, the overflow counters and the contact count must be
identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from physics_tpu import scenes as jscenes
from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import bf16_pair_exact, jax_arrays

N = 192
TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 4e-3}
EXACT = ("contact_key", "contact_order", "contact_meta", "step_count")
COUNTERS = ("contact_count", "pair_overflow", "contact_overflow",
            "band_overflow")


def _rounded(s):
    """The state with pos and quat rounded to 16 significant bits."""
    return s.replace(pos=jnp.asarray(bf16_pair_exact(s.pos)),
                     quat=jnp.asarray(bf16_pair_exact(s.quat)))


@pytest.fixture(scope="module")
def jax_run():
    """States before and after a rebuild step (step 4) and a refresh step
    (step 5) of the JAX package, with their metrics; each step starts
    from a rounded state."""
    cfg = jscenes.rain_config(N).replace(z_bf16=False)
    s = jax_prepare(jscenes.mesh_rain(N, real_assets=False), cfg)
    run = jax.jit(jax_step, static_argnums=1)
    for _ in range(4):
        s, _ = run(s, cfg)
    s4 = _rounded(s)
    s5, m5 = run(s4, cfg)
    s5 = _rounded(s5)
    s6, m6 = run(s5, cfg)
    return {"rebuild": (s4, s5, m5), "refresh": (s5, s6, m6)}


@pytest.mark.parametrize("which", ["rebuild", "refresh"])
def test_step_matches(jax_run, which):
    src, dst, jm = jax_run[which]
    cfg = tscenes.rain_config(N)
    ts, tm = step_with_metrics(state_from_arrays(jax_arrays(src), "cpu"),
                               cfg)
    ja, ta = jax_arrays(dst), to_numpy(ts)
    assert ts.step_count_host == int(ja["step_count"])
    for k, tol in TOL.items():
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=tol,
                                   err_msg=k)
    for k in EXACT:
        assert np.array_equal(ta[k], ja[k]), k
    for k in COUNTERS:
        assert int(tm[k]) == int(jm[k]), k
    assert int(jm["contact_count"]) > 200
    # the persisted table carries the same contacts (activity, keys,
    # ranks and slot ids are integer-valued rows)
    for r in (9, 10, 11, 12, 13, 14, 15):
        assert np.array_equal(ta["contact_table"][r],
                              ja["contact_table"][r]), r
    np.testing.assert_allclose(float(tm["max_penetration"]),
                               float(jm["max_penetration"]), atol=1e-3)
