"""The contact table: physics_tpu_torch's plain version (the CPU side of
kernel csrc/contact_table.cu) against the JAX package's Pallas kernel in
interpret mode, on the rebuild of a contact-rich two-bucket pile with
bucket_cap2, warm start and anchors on.

Tolerances. The JAX kernel gathers geometry and scatters its payload
through hi/lo bf16 splits, exact to about 2⁻¹⁷ of each value. The
geometry is rounded to 16 significant bits first, which that split
carries exactly, so both sides read the same inputs; the remaining
difference is the payload split plus f32 operation order, held to
4·2⁻¹⁷ times the scene extent (the largest |coordinate|). Keys, activity,
ranks and the meta counters must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu_torch.ops import broadphase as tbp
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.state import state_from_arrays

from tests.test_torch_config_scene import (
    bf16_pair_exact,
    configs,
    dense_pile,
    jax_arrays,
)

N = 192
EXACT_ROWS = [tct.CT_ACT, tct.CT_KL, tct.CT_KH, tct.CT_KSGN, tct.CT_RA,
              tct.CT_RB1, tct.CT_KS, tct.CT_MU, tct.CT_REST]


@pytest.fixture(scope="module")
def tables():
    cfg_j, cfg_t = configs(N)
    s = dense_pile(N)
    order = jbp.sweep_order(s, jbp.body_aabbs(s))
    cand = jbp.pair_candidates(s, cfg_j)
    geom = bf16_pair_exact(jct.unified_geom(s, cfg_j, order))
    nb, ccap, cp = jct.table_shape(N, cfg_j)
    run = jax.jit(lambda c, g, pk, pl: jct.bucket_contact_table(
        s, c, cfg_j, order, prev=(pk, pl), geom=g))
    # cold warm start, then a warm start keyed on the first table's keys
    # with impulses that the bf16 split carries exactly
    t0, _, _ = run(cand, jnp.asarray(geom), jnp.zeros((2, cp), jnp.int32),
                   jnp.zeros((3, cp), jnp.float32))
    keys = np.asarray(jct.table_keys(t0))
    rng = np.random.default_rng(4)
    lam = bf16_pair_exact(rng.uniform(0.0, 1.0, (3, cp)))
    # drop a third of the previous contacts: their slots must start cold
    keys = keys * (rng.random(cp) > 0.33)[None, :].astype(np.int32)
    jt, jm, jw = map(np.asarray, run(cand, jnp.asarray(geom),
                                     jnp.asarray(keys), jnp.asarray(lam)))

    ts = state_from_arrays(jax_arrays(s), "cpu")
    tc = PairCandidates(*[torch.from_numpy(np.array(x)) for x in cand])
    tt, tm, tw = tct.bucket_contact_table(
        ts, tc, cfg_t, prev=(torch.from_numpy(keys), torch.from_numpy(lam)),
        geom=torch.from_numpy(geom))
    extent = float(np.abs(geom[0:3, :N]).max())
    return (jt, jm, jw), (tt.numpy(), tm.numpy(), tw.numpy()), extent


def test_table_integer_rows_and_meta_identical(tables):
    (jt, jm, jw), (tt, tm, tw), _ = tables
    assert tt.shape == jt.shape == (32, 2 * 640)
    assert jt[tct.CT_ACT].sum() > 300                    # contact-rich
    assert (jt[tct.CT_KSGN] * jt[tct.CT_ACT]).sum() < jt[tct.CT_ACT].sum()
    for r in EXACT_ROWS:
        assert np.array_equal(tt[r], jt[r]), r
    assert np.array_equal(tct.table_keys(torch.from_numpy(tt)).numpy(),
                          np.asarray(jct.table_keys(jt)))
    assert np.array_equal(tm, jm)
    assert jm[0].reshape(-1, 128)[:, 1].sum() == jt[tct.CT_ACT].sum()


def test_table_f32_rows_within_tolerance(tables):
    (jt, _, _), (tt, _, _), extent = tables
    tol = 4 * 2.0 ** -17 * extent
    for r in range(32):
        np.testing.assert_allclose(tt[r], jt[r], rtol=0, atol=tol,
                                   err_msg=f"row {r}")


def test_warm_start_matches(tables):
    (_, _, jw), (_, _, tw), _ = tables
    assert np.count_nonzero(jw[0]) > 100
    assert np.count_nonzero(jw[0] == 0) > 100            # cold slots
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("buckets", [(0, 1), (1, 1)])
def test_bucket_range_is_the_column_block(buckets):
    """The row-sharded step's mode: buckets=(bucket0, nb) from the
    candidates and previous keys of those buckets gives exactly the full
    table's blocks of those buckets (plain version; the kernel is held to
    the same on the card)."""
    _, cfg_t = configs(N)
    ts = state_from_arrays(jax_arrays(dense_pile(N)), "cpu")
    order = tbp.sweep_order(ts, tbp.body_aabbs(ts))
    cand = tbp.pair_candidates(ts, cfg_t, order=order)
    geom = tct.unified_geom(ts, cfg_t, order)
    t0, _, _ = tct.bucket_contact_table(ts, cand, cfg_t, geom=geom)
    nb, ccap, cp = tct.table_shape(N, cfg_t)
    _, cap, _ = tbp.bucket_shape(N, cfg_t)
    rng = np.random.default_rng(5)
    prev = (tct.table_keys(t0), torch.from_numpy(
        rng.uniform(0.0, 1.0, (3, cp)).astype(np.float32)))
    full = tct.bucket_contact_table(ts, cand, cfg_t, prev=prev, geom=geom)
    b0, nbl = buckets
    lanes = slice(b0 * cap, (b0 + nbl) * cap)
    cols = slice(b0 * ccap, (b0 + nbl) * ccap)
    part = tct.bucket_contact_table(
        ts, PairCandidates(*[x[lanes] if x.dim() else x for x in cand]),
        cfg_t, prev=(prev[0][:, cols], prev[1][:, cols]), geom=geom,
        buckets=buckets)
    assert full[0][tct.CT_ACT, cols].sum() > 100
    assert torch.equal(part[0], full[0][:, cols])
    assert torch.equal(part[1], full[1][:, b0 * 128:(b0 + nbl) * 128])
    assert torch.equal(part[2], full[2][:, cols])
