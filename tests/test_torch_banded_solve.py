"""The banded solve: physics_tpu_torch's plain version (the CPU side of
kernel csrc/banded_solve.cu) against the JAX package's fused Pallas solve
(banded_sweeps_fused) in interpret mode, for the rebuild schedule (8
velocity + 8 position sweeps, 9 in all) and the anchored refresh
schedule (4 + 4, 5 in all) of the 4k pile's config, with warm start and
fused integration.

Tolerance: the JAX kernel reads the velocity table through a hi/lo bf16
split (about 2⁻¹⁷ relative per read) on each of up to 9 sweeps, and both
sides sum the impulse deltas in different orders; outputs are held to
1e-4 (≈ 13·2⁻¹⁷) of each row's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu.solver import contacts_pallas as jcp
from physics_tpu_torch.solver.banded_solve import banded_sweeps_fused

from tests.test_torch_config_scene import (
    bf16_pair_exact,
    configs,
    dense_pile,
)

N = 192


@pytest.fixture(scope="module")
def rebuild():
    """(state, order, table, geom) of a rebuild of the dense pile."""
    cfg_j, _ = configs(N)
    s = dense_pile(N)
    order = jbp.sweep_order(s, jbp.body_aabbs(s))
    cand = jbp.pair_candidates(s, cfg_j)
    geom = bf16_pair_exact(jct.unified_geom(s, cfg_j, order))
    table, _, _ = jax.jit(lambda c, g: jct.bucket_contact_table(
        s, c, cfg_j, order, geom=g))(cand, jnp.asarray(geom))
    return s, order, np.array(table), geom


def _inputs(rebuild, schedule):
    """(table, warm8, geom) of the rebuild; for the refresh schedule the
    bodies have then moved (anchors re-derive every contact from the
    moved poses, and some separate)."""
    cfg_j, _ = configs(N)
    s, order, table, geom = rebuild
    cp = table.shape[1]
    rng = np.random.default_rng(5)
    act = table[jct.CT_ACT]
    warm8 = np.zeros((8, cp), np.float32)
    warm8[0] = rng.uniform(0.0, 0.3, cp) * act
    warm8[1:3] = rng.uniform(-0.05, 0.05, (2, cp)) * act
    if schedule == "refresh":
        moved = s.replace(
            pos=s.pos + jnp.asarray(rng.normal(0, 0.01, (N, 3)), jnp.float32),
            quat=s.quat + jnp.asarray(rng.normal(0, 0.005, (N, 4)),
                                      jnp.float32))
        moved = moved.replace(quat=moved.quat / jnp.linalg.norm(
            moved.quat, axis=1, keepdims=True))
        geom = bf16_pair_exact(jct.unified_geom(moved, cfg_j, order))
    return table, warm8, geom


@pytest.mark.parametrize("schedule,iters", [("rebuild", 8), ("refresh", 4)])
def test_banded_sweeps_fused_matches(rebuild, schedule, iters):
    cfg_j, cfg_t = configs(N)
    table, warm8, geom = _inputs(rebuild, schedule)
    nb, ccap, cp = jct.table_shape(N, cfg_j)
    wtot, npad = jct.geom_pad(N, cfg_j)
    bases = jnp.asarray(np.arange(nb) * 128, jnp.int32)
    run = jax.jit(lambda tb, w, g: jcp.banded_sweeps_fused(
        tb, w, g, bases, cfg_j, tile=ccap, wtot=wtot, vel_iters=iters,
        pos_iters=iters, use_split=True, integrate=(cfg_j.dt, True)))
    jz, jl, jp = map(np.asarray, run(jnp.asarray(table), jnp.asarray(warm8),
                                     jnp.asarray(geom)))
    tz, tl, tp = [x.numpy() for x in banded_sweeps_fused(
        torch.from_numpy(table), torch.from_numpy(warm8),
        torch.from_numpy(geom), cfg_t, vel_iters=iters, pos_iters=iters,
        use_split=True, integrate=(cfg_t.dt, True))]

    # the solve moved things: degrees, impulses and velocities are live
    assert jz[14, :N].max() >= 4 and np.abs(jl[0]).sum() > 10
    if schedule == "refresh":
        # some anchored contacts separated (row 3 = refreshed depth·act)
        assert (jl[3] > 0).sum() < (table[jct.CT_ACT] > 0).sum()
    for name, a, b in (("z", jz[:, :N], tz[:, :N]), ("lam", jl, tl),
                       ("posq", jp[:, :N], tp[:, :N])):
        for r in range(a.shape[0]):
            tol = 1e-4 * max(float(np.abs(a[r]).max()), 1e-3)
            np.testing.assert_allclose(b[r], a[r], rtol=0, atol=tol,
                                       err_msg=f"{name} row {r}")
