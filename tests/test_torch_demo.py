"""The reference engine's own scene on physics_tpu_torch, on the CPU:
demo_scene() under compat_config(dt=1/60) (one cube pinned to the origin
and held at euler 0, Baumgarte ks 10, kd 1, with the quirks Q1-Q7)
against the JAX package's step and against the port's copy of the NumPy
oracle, which is held to the JAX package's oracle bit for bit.

Tolerances: tests/test_demo_parity.py's. One step: pos, vel and quat
rtol 1e-5 / atol 1e-6, ω and λ 1e-4 / 1e-5; 300 steps: the largest
position error < 1e-3 and the final quaternion's < 1e-2 (f32 op-order
drift).
"""

import numpy as np
import pytest
import torch

import jax

from physics_tpu import scene as jscene
from physics_tpu.config import compat_config as jax_compat_config
from physics_tpu.engine import step_with_metrics as jax_step
from physics_tpu.oracle import reference as jax_oracle

from physics_tpu_torch.config import compat_config
from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.oracle import reference as oracle
from physics_tpu_torch.scene import demo_scene
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import jax_arrays

DT = 1.0 / 60.0


def test_demo_scene_arrays_match():
    """demo_scene's every array bit for bit the JAX package's; the scene
    builds on the card unless the caller asks for the CPU."""
    ja, ta = jax_arrays(jscene.demo_scene()), to_numpy(
        demo_scene(device="cpu"))
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo_scene()


def test_one_step_matches_jax_and_oracle():
    state = demo_scene(device="cpu")
    s1, m = step_with_metrics(state, compat_config(dt=DT))
    js, jm = jax.jit(jax_step, static_argnums=1)(jscene.demo_scene(),
                                                 jax_compat_config(dt=DT))
    ora = oracle.demo_scene()
    ora.update(DT)
    assert bool(m["cg_converged"]) and bool(jm["cg_converged"])
    assert int(m["cg_iters"]) == int(jm["cg_iters"])
    body = ora.bodies[0]
    ja = jax_arrays(js)
    for name, want, tol in (("pos", body.position, (1e-5, 1e-6)),
                            ("vel", body.lin_velocity, (1e-5, 1e-6)),
                            ("omega", body.angular_velocity, (1e-4, 1e-5)),
                            ("quat", body.rotation, (1e-5, 1e-6))):
        got = getattr(s1, name)[0].numpy()
        for ref in (want, ja[name][0]):
            np.testing.assert_allclose(got, ref, rtol=tol[0], atol=tol[1],
                                       err_msg=name)
    for ref in (ora.previous_solution, ja["lam_joint"]):
        np.testing.assert_allclose(s1.lam_joint.numpy(), ref, rtol=1e-4,
                                   atol=1e-5)


def test_300_steps_track_the_oracle():
    """5 s of the swinging cube: the port's copy of the oracle steps the
    JAX package's oracle's trajectory bit for bit, and the port tracks
    it; the cube swings (x 1.0 → −0.6 at 1 s → +0.36 at 2 s)."""
    state = demo_scene(device="cpu")
    cfg = compat_config(dt=DT)
    ora, jora = oracle.demo_scene(), jax_oracle.demo_scene()
    max_err, xs = 0.0, {}
    for i in range(300):
        state, _ = step_with_metrics(state, cfg)
        ora.update(DT)
        jora.update(DT)
        assert np.array_equal(ora.bodies[0].position,
                              jora.bodies[0].position)
        pos = state.pos[0].numpy()
        max_err = max(max_err, float(np.max(np.abs(
            pos - ora.bodies[0].position))))
        if i + 1 in (60, 120):
            xs[i + 1] = float(pos[0])
    assert np.array_equal(ora.bodies[0].rotation, jora.bodies[0].rotation)
    assert np.all(np.isfinite(state.pos.numpy()))
    assert max_err < 1e-3, max_err
    qerr = float(np.max(np.abs(state.quat[0].numpy()
                               - ora.bodies[0].rotation)))
    assert qerr < 1e-2, qerr
    assert -0.7 < xs[60] < -0.5 and 0.3 < xs[120] < 0.42
    assert state.step_count_host == 300
