"""physics_tpu_torch's joints and compat mode against physics_tpu on the
CPU: the joint rows and their matrix-free products, the CG (the plain
version of csrc/joint_cg.cu), compat gravity and the compat integrator,
the packed pendulum envs stepped as one scene, a jointed state carried
across the packages, and the jointed step's refusals.

The inputs are made from seeded numpy and given to both packages.
Tolerances: the joint rows and products to f32 ulps (1e-6 absolute and
relative on values of order 1: the anchor rotations and the euler
extraction take their sin/atan2 from different libraries, and XLA may
associate the 3- and 6-term sums differently); the CG's result to
1e-4 / 1e-5 (the reference's own CG test) with the iteration count and
the stop equal; compat gravity and integration as tests/test_integrator.py
holds them (1e-6, ω 1e-5); the packed pendulums as
tests/test_pack_envs.py holds them (pos atol 2e-4, vel atol 1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig as JaxConfig
from physics_tpu.config import compat_config as jax_compat_config
from physics_tpu.engine import _w_apply as jax_w_apply
from physics_tpu.engine import solve_joints as jax_solve_joints
from physics_tpu.engine import step as jax_step
from physics_tpu.engine import step_with_metrics as jax_step_with_metrics
from physics_tpu.envs import pack_envs as jax_pack_envs
from physics_tpu.io.meshes import box_inertia as jax_box_inertia
from physics_tpu.maths import linalg as jlinalg
from physics_tpu.maths import quaternion as jquat
from physics_tpu.ops.forces import apply_gravity as jax_gravity
from physics_tpu.ops.integrator import (
    integrate_positions as jax_integrate_positions,
    integrate_velocities as jax_integrate_velocities,
)
from physics_tpu.oracle.reference import _solve_cg as jax_oracle_cg
from physics_tpu.scene import SceneBuilder as JaxBuilder
from physics_tpu.solver import cg as jcg
from physics_tpu.solver import joints as jjoints
from physics_tpu.state import make_state

from physics_tpu_torch.config import SimConfig, compat_config
from physics_tpu_torch.maths import linalg as tlinalg
from physics_tpu_torch.maths import quaternion as tquat
from physics_tpu_torch.engine import (
    _w_blocks,
    solve_joints,
    step_with_metrics,
)
from physics_tpu_torch.ops.forces import apply_gravity
from physics_tpu_torch.ops.integrator import (
    integrate_positions,
    integrate_velocities,
)
from physics_tpu_torch.oracle.reference import _solve_cg as oracle_cg
from physics_tpu_torch.parallel.collectives import Shard
from physics_tpu_torch.scene import SceneBuilder
from physics_tpu_torch.solver import cg
from physics_tpu_torch.solver import joints as tjoints
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import jax_arrays
from tests.test_torch_pendulums import packed_pendulums, pendulum

ROW_TOL = dict(rtol=1e-6, atol=1e-6)


def _all_types(builder_cls, rng, **build):
    """Five bodies at seeded poses and velocities with every joint type,
    a two-body ball joint and distance joint, and two dead slots."""
    b = builder_cls()
    for _ in range(5):
        b.add_body(pos=rng.normal(size=3), euler=rng.normal(size=3) * 0.4,
                   vel=rng.normal(size=3), omega=rng.normal(size=3))
    b.fix_to_point(0, (0.1, 0.2, 0.3))
    b.fix_orientation(1, (0.0, 0.1, -0.2), ks=5.0, kd=0.5)
    b.ball_joint(1, 2, (0.5, 0, 0), (-0.5, 0, 0))
    b.distance_joint(2, 3, (0, 0.3, 0), (0, -0.3, 0), 1.5)
    b.ball_joint(4, 0, (0, 0.2, 0.1), (0.3, 0, 0))
    return b.build(joint_capacity=7, **build)


def _both_all_types(seed=3):
    js = _all_types(JaxBuilder, np.random.default_rng(seed))
    ts = _all_types(SceneBuilder, np.random.default_rng(seed),
                    device="cpu")
    return js, ts


def test_joint_maths_match():
    """rotate, from_euler, to_euler (its main branch and both gimbal-lock
    branches), inv3x3 and skew against the JAX package's."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # R₂₀ exactly −1 and +1: the two gimbal-lock branches of to_euler
    q[0] = (0.5, -0.5, 0.5, 0.5)
    q[1] = (0.5, 0.5, -0.5, 0.5)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    rpy = rng.uniform(-3, 3, size=(32, 3)).astype(np.float32)
    a = rng.normal(size=(32, 3, 3)).astype(np.float32)
    m = (a @ a.transpose(0, 2, 1) + 2 * np.eye(3, dtype=np.float32))
    t = torch.from_numpy
    qe = jquat.from_euler(*rpy.T)
    pairs = [
        (jquat.rotate(q, v), tquat.rotate(t(q), t(v))),
        (qe, tquat.from_euler(*t(rpy).T)),
        (jquat.to_euler(q), tquat.to_euler(t(q))),
        (jquat.to_euler(qe), tquat.to_euler(t(np.array(qe)))),
        (jlinalg.inv3x3(m), tlinalg.inv3x3(t(m))),
        (jlinalg.skew(v), tlinalg.skew(t(v))),
    ]
    for j, tt in pairs:
        np.testing.assert_allclose(tt.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_builders_and_state_arrays_match():
    """SceneBuilder's joint methods and build(joint_capacity=) give the
    JAX package's arrays bit for bit (dead slots included), and a
    capacity below the joint count raises."""
    js, ts = _both_all_types()
    ja, ta = jax_arrays(js), to_numpy(ts)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k
    assert ts.joints.capacity == 7 and ts.lam_joint.shape == (21,)
    b = SceneBuilder()
    b.fix_to_point(b.add_body(), (0, 0, 0))
    with pytest.raises(ValueError, match="joint_capacity"):
        b.build(joint_capacity=0, device="cpu")


def test_jointed_state_crosses_both_ways():
    """A jointed JAX state (stepped twice, so λ is warm) into the port and
    back, every array bit for bit."""
    js, _ = _both_all_types()
    run = jax.jit(jax_step, static_argnums=1)
    cfg = JaxConfig(dt=1.0 / 120.0)
    js = run(run(js, cfg), cfg)
    arrays = jax_arrays(js)
    assert np.any(arrays["lam_joint"] != 0)
    back = to_numpy(state_from_arrays(arrays, "cpu"))
    for k in arrays:
        assert np.array_equal(back[k], arrays[k]), k


def test_joint_rows_match():
    """Every JointRows field, all four types and the dead slots."""
    js, ts = _both_all_types()
    jr, tr = jjoints.joint_rows(js), tjoints.joint_rows(ts)
    for f in jr._fields:
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)),
                                   err_msg=f, **ROW_TOL)
    assert np.all(tr.rowmask[5:].numpy() == 0)
    assert tr.rowmask[3].tolist() == [1.0, 0.0, 0.0]


def test_matvecs_match():
    """J·x, J̇·x and Jᵀ·λ on seeded vectors."""
    js, ts = _both_all_types()
    jr, tr = jjoints.joint_rows(js), tjoints.joint_rows(ts)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    lam = rng.normal(size=(21,)).astype(np.float32)
    pairs = [
        (jjoints.j_matvec(jr, jnp.asarray(x)),
         tjoints.j_matvec(tr, torch.from_numpy(x))),
        (jjoints.jd_matvec(jr, jnp.asarray(x)),
         tjoints.jd_matvec(tr, torch.from_numpy(x))),
        (jjoints.jt_matvec(jr, jnp.asarray(lam), 5),
         tjoints.jt_matvec(tr, torch.from_numpy(lam), 5)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ROW_TOL)


@pytest.mark.parametrize("compat", [False, True])
def test_inverse_mass_matches(compat):
    """W·x (the W blocks through joints.apply_w) against JAX _w_apply:
    the world-frame inverse inertia, and in compat 1/m on all six DOFs
    (quirk Q3)."""
    js, ts = _both_all_types()
    x = np.random.default_rng(4).normal(size=(5, 6)).astype(np.float32)
    cj, ct = JaxConfig(compat=compat), SimConfig(compat=compat)
    got = tjoints.apply_w(_w_blocks(ts, ct), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_w_apply(js, cj, jnp.asarray(x))),
                               **ROW_TOL)


# tests/test_cg.py's cases: (matrix, rhs, x0, solve keywords)
def _cg_case(name):
    if name == "spd":
        rng = np.random.default_rng(0)
        a = rng.normal(size=(12, 12)).astype(np.float32)
        a = a @ a.T + 12 * np.eye(12, dtype=np.float32)
        rhs = rng.normal(size=12).astype(np.float32)
        return a, rhs, np.zeros(12, np.float32), dict(rel_tol=1e-6,
                                                      abs_tol=1e-8)
    if name == "zero_residual":
        a = np.eye(4, dtype=np.float32) * 2.0
        rhs = np.array([2.0, 4.0, 6.0, 8.0], np.float32)
        return a, rhs, rhs / 2.0, {}
    if name == "amax_stop":
        a = np.diag(np.array([1.0, 10.0, 100.0], np.float32))
        return a, np.ones(3, np.float32), np.zeros(3, np.float32), dict(
            max_iters=1000, rel_tol=1e-2, abs_tol=1e-3)
    if name == "no_convergence":
        a = np.diag(np.array([1e-8, 1.0, 1e8], np.float32))
        return a, np.ones(3, np.float32), np.zeros(3, np.float32), dict(
            max_iters=2, rel_tol=1e-9, abs_tol=1e-12)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(9, 9)).astype(np.float32)
    a = a @ a.T + 9 * np.eye(9, dtype=np.float32)
    rhs = rng.normal(size=9).astype(np.float32)
    warm = rng.normal(size=9).astype(np.float32) * 0.1
    return a, rhs, warm, {}


@pytest.mark.parametrize("name", ["spd", "zero_residual", "amax_stop",
                                  "no_convergence", "oracle"])
def test_plain_cg_matches(name):
    """solve_plain against physics_tpu.solver.cg.solve on
    tests/test_cg.py's five systems: x within 1e-4 / 1e-5, iterations and
    stop equal; the last also against the oracle copy's CG, which must
    equal the JAX package's oracle CG bit for bit."""
    a, rhs, x0, kw = _cg_case(name)
    xj, cj, ij = jcg.solve(lambda v: jnp.asarray(a) @ v, jnp.asarray(rhs),
                           jnp.asarray(x0), **kw)
    at = torch.from_numpy(a)
    xt, ct, it = cg.solve_plain(lambda v: at @ v, torch.from_numpy(rhs),
                                torch.from_numpy(x0), **kw)
    assert bool(ct) == bool(cj) and int(it) == int(ij)
    assert ct.dtype == torch.bool and it.dtype == torch.int32
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-5)
    if name == "no_convergence":
        assert not bool(ct) and int(it) == 2
    else:
        assert bool(ct) and np.all(np.isfinite(xt.numpy()))
    if name == "oracle":
        def op(v):
            return (a @ v).astype(np.float32)
        xo = oracle_cg(op, rhs, x0)
        assert np.array_equal(xo, jax_oracle_cg(op, rhs, x0))
        np.testing.assert_allclose(xt.numpy(), xo, rtol=1e-4, atol=1e-5)


def test_slot_dot_is_the_pairwise_tree():
    """slot_dot's order, which csrc/joint_cg.cu reproduces: each slot's
    rows (r₀ + r₁) + r₂, then adjacent pairs level by level over the
    slots padded with zeros to a power of two — against that recursion
    written out in f32 numpy, bit for bit, at 1, 5, 8 and 1,000 slots."""
    def tree(v):
        if len(v) == 1:
            return v[0]
        h = len(v) // 2
        return np.float32(tree(v[:h]) + tree(v[h:]))
    for slots in (1, 5, 8, 1000):
        rng = np.random.default_rng(slots)
        a = rng.normal(size=3 * slots).astype(np.float32)
        b = rng.normal(size=3 * slots).astype(np.float32)
        p = a * b
        s = list((p[0::3] + p[1::3]) + p[2::3])
        width = 1
        while width < slots:
            width *= 2
        want = tree(s + [np.float32(0)] * (width - slots))
        got = cg.slot_dot(torch.from_numpy(a), torch.from_numpy(b))
        assert got.item() == want


def _compat_bodies(seed=42, n=16):
    """tests/test_integrator.py's random bodies as plain arrays."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("pos", "quat", "vel", "omega", "force",
                           "torque", "mass", "inertia")}
    for _ in range(n):
        out["pos"].append(rng.normal(size=3))
        q = rng.normal(size=4)
        out["quat"].append(q / np.linalg.norm(q))
        out["vel"].append(rng.normal(size=3))
        out["omega"].append(rng.normal(size=3))
        out["force"].append(rng.normal(size=3))
        out["torque"].append(rng.normal(size=3))
        out["mass"].append(rng.uniform(0.5, 3.0))
        a = rng.normal(size=(3, 3))
        out["inertia"].append(a @ a.T + 2.0 * np.eye(3))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _both_compat_states(omega_zero=()):
    b = _compat_bodies()
    b["omega"][list(omega_zero)] = 0.0
    js = make_state(pos=b["pos"], quat=b["quat"], vel=b["vel"],
                    omega=b["omega"], mass=b["mass"],
                    inertia=b["inertia"]).replace(
        force=jnp.asarray(b["force"]), torque=jnp.asarray(b["torque"]))
    return js, state_from_arrays(jax_arrays(js), "cpu")


@pytest.mark.parametrize("offset", [(0.0, 0.0, 1.5), (0.2, -0.4, 0.0)])
def test_compat_gravity_and_integration_match(offset):
    """compat gravity (quirk Q5: unscaled, at an offset) and both compat
    integrator phases (Q2 sin(θ/2), Q4 inertia inverted each step)
    against JAX; then the position phase alone, where bodies 3 and 7
    have ω = 0 (Q6, the exact-zero gate: q unchanged)."""
    js, ts = _both_compat_states(omega_zero=(3, 7))
    cj = jax_compat_config(dt=1.0 / 60.0, gravity_offset=offset)
    ct = compat_config(dt=1.0 / 60.0, gravity_offset=offset)
    jg, tg = jax_gravity(js, cj), apply_gravity(ts, ct)
    jv, tv = jax_integrate_velocities(jg, cj), integrate_velocities(tg, ct)
    jp, tp = jax_integrate_positions(jv, cj), integrate_positions(tv, ct)
    for (j, t, keys) in ((jg, tg, ("force", "torque")),
                         (jv, tv, ("vel", "omega")),
                         (jp, tp, ("pos", "quat", "force", "torque"))):
        ja, ta = jax_arrays(j), to_numpy(t)
        for k in keys:
            tol = 1e-5 if k == "omega" else 1e-6
            np.testing.assert_allclose(ta[k], ja[k], rtol=tol, atol=tol,
                                       err_msg=k)
    assert tp.step_count_host == 1
    # the gate alone: the position phase of ω = 0 leaves q as it is
    jq = jax_integrate_positions(js, cj).quat
    tq = integrate_positions(ts, ct).quat.numpy()
    np.testing.assert_allclose(tq, np.asarray(jq), rtol=1e-6, atol=1e-6)
    assert np.array_equal(tq[[3, 7]], ts.quat.numpy()[[3, 7]])


def test_gravity_unscaled_and_offset_noncompat():
    """gravity_scale_by_mass=False and a non-zero gravity_offset outside
    compat, on bodies of random mass and one static body."""
    js, ts = _both_compat_states()
    mass = np.asarray(js.mass).copy()
    mass[2] = np.inf
    arrays = jax_arrays(js)
    arrays["mass"] = mass
    arrays["inv_mass"] = np.where(np.isinf(mass), 0, 1 / mass).astype(
        np.float32)
    js = js.replace(mass=jnp.asarray(mass),
                    inv_mass=jnp.asarray(arrays["inv_mass"]))
    ts = state_from_arrays(arrays, "cpu")
    for kw in (dict(gravity_scale_by_mass=False),
               dict(gravity_offset=(0.0, 0.3, -0.1)),
               dict(gravity_scale_by_mass=False,
                    gravity_offset=(0.5, 0.0, 0.0))):
        ja = jax_arrays(jax_gravity(js, JaxConfig(**kw)))
        ta = to_numpy(apply_gravity(ts, SimConfig(**kw)))
        for k in ("force", "torque"):
            np.testing.assert_allclose(ta[k], ja[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{kw} {k}")


def test_q7_no_force_and_stale_warm_start():
    """cg_max_iters=1 on the all-types scene: the CG does not converge,
    so no constraint force is applied and λ stays the previous step's
    (quirk Q7), as in JAX."""
    js, ts = _both_all_types()
    lam0 = np.random.default_rng(9).normal(size=21).astype(np.float32)
    js = js.replace(lam_joint=jnp.asarray(lam0))
    ts = ts.replace(lam_joint=torch.from_numpy(lam0))
    cj, ct = JaxConfig(cg_max_iters=1), SimConfig(cg_max_iters=1)
    sj, mj = jax_solve_joints(jax_gravity(js, cj), cj)
    tg = apply_gravity(ts, ct)
    st, mt = solve_joints(tg, ct)
    assert not bool(mt["cg_converged"]) and not bool(mj["cg_converged"])
    assert int(mt["cg_iters"]) == int(mj["cg_iters"]) == 1
    assert np.array_equal(st.lam_joint.numpy(), lam0)
    assert torch.equal(st.force, tg.force) and torch.equal(st.torque,
                                                           tg.torque)
    np.testing.assert_allclose(st.force.numpy(), np.asarray(sj.force),
                               rtol=1e-6, atol=1e-6)


def test_joint_step_matches():
    """Whole non-compat steps of the all-types scene (gravity, joints,
    integration) from identical states, step by step for 6 steps: pos
    and quat to 2e-5, vel, ω and λ to 2e-4 (the CGs stop on the same
    iteration; λ is a near-singular solve's result)."""
    js, ts = _both_all_types()
    cj, ct = JaxConfig(dt=1.0 / 120.0), SimConfig(dt=1.0 / 120.0)
    run = jax.jit(jax_step_with_metrics, static_argnums=1)
    for _ in range(6):
        sj, mj = run(js, cj)
        st, mt = step_with_metrics(state_from_arrays(jax_arrays(js), "cpu"),
                                   ct)
        assert int(mt["cg_iters"]) == int(mj["cg_iters"])
        assert bool(mt["cg_converged"]) == bool(mj["cg_converged"])
        ja, ta = jax_arrays(sj), to_numpy(st)
        for k, tol in (("pos", 2e-5), ("quat", 2e-5), ("vel", 2e-4),
                       ("omega", 2e-4), ("lam_joint", 2e-4)):
            np.testing.assert_allclose(ta[k], ja[k], rtol=tol, atol=tol,
                                       err_msg=k)
        js = sj


def jax_packed_pendulums(offs):
    base = pendulum(JaxBuilder, jax_box_inertia)
    o = jnp.asarray(offs)
    batched = jax.vmap(lambda v: base.replace(pos=base.pos + v))(o)
    pr = batched.joints.params
    batched = batched.replace(joints=batched.joints.replace(
        params=pr.at[:, 0, 0:3].add(o[:, 0, :])))
    return jax_pack_envs(batched)


def test_packed_pendulums_match():
    """3 packed pendulums: the port's pack_envs gives JAX pack_envs'
    arrays bit for bit, then 8 steps under SimConfig(dt=1/120) against
    JAX's packed step (tests/test_pack_envs.py's bounds)."""
    ts, offs = packed_pendulums(3)
    js = jax_packed_pendulums(offs)
    ja, ta = jax_arrays(js), to_numpy(ts)
    for k in ja:
        assert np.array_equal(ta[k], ja[k]), k
    assert ts.joints.capacity == 6 and ts.num_bodies == 6
    cj, ct = JaxConfig(compat=False, dt=1.0 / 120.0), SimConfig(
        compat=False, dt=1.0 / 120.0)
    run = jax.jit(jax_step, static_argnums=1)
    for _ in range(8):
        js = run(js, cj)
        ts, m = step_with_metrics(ts, ct)
        assert bool(m["cg_converged"])
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=2e-4)
    np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel), atol=1e-3)


def test_jointed_refusals():
    """A jointed state under shard= names ROADMAP 1.15; compat together
    with contacts names 1.11b."""
    ts, _ = packed_pendulums(2)
    with pytest.raises(NotImplementedError, match="1.15"):
        step_with_metrics(ts, SimConfig(), shard=Shard(None, 0, 2))
    b = SceneBuilder()
    b.set_box(b.add_body(pos=(0, 2, 0)), (0.5,) * 3)
    s = b.build(device="cpu")
    cfg = compat_config(ground_plane=True, contact_solver="pallas_banded",
                        boxes_only=True)
    with pytest.raises(NotImplementedError, match="1.11b"):
        step_with_metrics(s, cfg)
