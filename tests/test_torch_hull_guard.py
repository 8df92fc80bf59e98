"""The hull table path's global motion guard (rain_config with
contact_rebuild_vel_factor 2): physics_tpu_torch.engine.step_with_metrics
(kernels' plain versions on the CPU) against physics_tpu's jitted step
(Pallas kernels in interpret mode), from IDENTICAL states, on a rain of
48 hexagonal bipyramids (triangle faces, E = 3) squeezed into contact. Step 1 is not a
scheduled rebuild (K = 4), but the fastest body covers more than
2 slops in K steps, so the guard rebuilds: the port reads that one
device predicate back on the host, the JAX package branches on it in
lax.cond.

Tolerances: the whole-step contract of tests/test_torch_rain_slice.py,
poses rounded to 16 significant bits first. Contact keys, the rank
order, the overflow counters, the contact count and contact_ref (reset
to the step's poses by the rebuild) must be identical.
"""

import numpy as np

import jax
import jax.numpy as jnp

from physics_tpu import scenes as jscenes
from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.solver.contacts import _rebuild_now
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import bf16_pair_exact, jax_arrays
from tests.test_torch_hull_faces import VERTS, jax_hull_rain

N = 48
TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 4e-3}
EXACT = ("contact_key", "contact_order", "contact_meta", "contact_ref",
         "step_count")
COUNTERS = ("contact_count", "pair_overflow", "contact_overflow",
            "band_overflow")


def _rounded(s):
    return s.replace(pos=jnp.asarray(bf16_pair_exact(s.pos)),
                     quat=jnp.asarray(bf16_pair_exact(s.quat)))


def test_guard_step_matches():
    cfg_j = jscenes.rain_config(N).replace(z_bf16=False,
                                           contact_rebuild_vel_factor=2.0)
    cfg_t = tscenes.rain_config(N).replace(contact_rebuild_vel_factor=2.0)
    run = jax.jit(jax_step, static_argnums=1)
    rain = jax_hull_rain(VERTS[3], N)
    pos = np.asarray(rain.pos) * np.float32([0.55, 0.45, 0.55])
    pos[:, 1] += 0.3
    s0 = _rounded(jax_prepare(rain.replace(pos=jnp.asarray(pos)), cfg_j))
    s1, _ = run(s0, cfg_j)
    s1 = _rounded(s1)
    s2, jm = run(s1, cfg_j)

    src = state_from_arrays(jax_arrays(s1), "cpu")
    assert src.step_count_host == 1 and _rebuild_now(src, cfg_t, True)
    ts, tm = step_with_metrics(src, cfg_t)
    ja, ta = jax_arrays(s2), to_numpy(ts)
    for key, tol in TOL.items():
        np.testing.assert_allclose(ta[key], ja[key], rtol=0, atol=tol,
                                   err_msg=key)
    for key in EXACT:
        assert np.array_equal(ta[key], ja[key]), key
    for key in COUNTERS:
        assert int(tm[key]) == int(jm[key]), key
    # the guard rebuilt: the references are the step's poses
    pose = np.concatenate([np.asarray(s1.pos), np.asarray(s1.quat)], axis=1)
    assert np.array_equal(ja["contact_ref"], pose)
    assert int(jm["contact_count"]) > 10
