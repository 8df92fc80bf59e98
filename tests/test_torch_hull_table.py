"""The hull contact table: physics_tpu_torch's plain version (the CPU side
of kernel csrc/hull_table.cu) against the JAX package's Pallas kernel in
interpret mode, with warm start on, on hull rains settled by 2 steps:
  - one bucket of 32 bevelled cubes, the K=1 table (CT_ROWS), prefilter
    on (bucket_cap2 256 of 384 candidate lanes);
  - two buckets (192 cubes) under rain_config: the anchored table
    (CT2_ROWS) with the 512-lane prefilter, across a bucket boundary;
  - one bucket of the 2-type library (cube, octahedron), K=1: all four
    ordered type pairs.
The scenes are stepped by the port (plain path) and the same arrays are
handed to both packages.

Tolerances. The JAX kernel reads geometry and moves its payload through
hi/lo bf16 splits, exact to about 2⁻¹⁷ of each value; the geometry and
the previous impulses are rounded to 16 significant bits first, which
the split carries exactly, so both sides read the same inputs. The
remaining difference is the payload split plus the summation order of
the SAT contractions (matmuls there, left-to-right sums here): f32 rows
within 4·2⁻¹⁷ × the scene extent, depth within 1e-4. Keys, activity,
ranks, slot ids, friction, restitution, the meta counters and the warm
rows must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu import scenes as jscenes
from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu.ops import hull_table as jht

from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.ops import broadphase as tbp
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops import hull_table as tht
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import bf16_pair_exact, jax_arrays

EXACT_ROWS = [tct.CT_ACT, tct.CT_KL, tct.CT_KH, tct.CT_KSGN, tct.CT_RA,
              tct.CT_RB1, tct.CT_KS, tct.CT_MU, tct.CT_REST]
CASES = {
    "one_bucket_k1": (32, 1, dict(bucket_cap2=256, contact_rebuild=1,
                                  contact_refresh_iters=0)),
    "two_buckets_anchored": (192, 1, {}),
    "mixed2_k1": (32, 2, dict(bucket_cap2=256, contact_rebuild=1,
                              contact_refresh_iters=0)),
}


def jax_state_like(js, arrays):
    """The JAX state `js` with every top-level array field replaced by
    the port's arrays (the nested shape and hull fields are identical by
    construction)."""
    top = {k: jnp.asarray(v) for k, v in arrays.items() if "." not in k}
    return js.replace(**top)


@pytest.fixture(scope="module", params=list(CASES))
def tables(request):
    n, types, over = CASES[request.param]
    if types == 1:
        js = jscenes.mesh_rain(n, real_assets=False)
    else:
        js = jscenes.mesh_rain_mixed(n, real_assets=False, n_types=types)
    cfg_t = tscenes.rain_config(n).replace(**over)
    cfg_j = jscenes.rain_config(n).replace(z_bf16=False, **over)
    ts = prepare_contacts(state_from_arrays(jax_arrays(js), "cpu"), cfg_t)
    for _ in range(2):
        ts, _ = step_with_metrics(ts, cfg_t)
    arrays = to_numpy(ts)
    arrays["contact_lam"] = bf16_pair_exact(arrays["contact_lam"])
    js = jax_state_like(js, arrays)
    ts = state_from_arrays(arrays, "cpu")

    order = jbp.sweep_order(js, jbp.body_aabbs(js))
    cand = jbp.pair_candidates(js, cfg_j)
    geom = bf16_pair_exact(jct.unified_geom(js, cfg_j, order, hulls=True))
    jt, jm, jw = map(np.asarray, jax.jit(
        lambda c, g, pk, pl: jht.bucket_hull_contact_table(
            js, c, cfg_j, order, prev=(pk, pl), geom=g))(
        cand, jnp.asarray(geom), js.contact_key, js.contact_lam))

    tc = PairCandidates(*[torch.from_numpy(np.array(x)) for x in cand])
    tt, tm, tw = tht.bucket_hull_contact_table(
        ts, tc, cfg_t, prev=(ts.contact_key, ts.contact_lam),
        geom=torch.from_numpy(geom))
    extent = float(np.abs(geom[0:3, :n]).max())
    return ((jt, jm, jw), (tt.numpy(), tm.numpy(), tw.numpy()), extent,
            cfg_t)


def test_integer_rows_and_meta_identical(tables):
    (jt, jm, jw), (tt, tm, tw), _, cfg = tables
    rows = tct.CT2_ROWS if cfg.contact_rebuild > 1 else tct.CT_ROWS
    assert tt.shape == jt.shape and tt.shape[0] == rows
    act = jt[tct.CT_ACT]
    assert act.sum() > 20
    assert 0 < (jt[tct.CT_KSGN] * act).sum() < act.sum()   # ground + pairs
    for r in EXACT_ROWS:
        assert np.array_equal(tt[r], jt[r]), r
    assert np.array_equal(tct.table_keys(torch.from_numpy(tt)).numpy(),
                          np.asarray(jct.table_keys(jt)))
    assert np.array_equal(tm, jm)
    assert jm[0].reshape(-1, 128)[:, 1].sum() == act.sum()


def test_f32_rows_within_tolerance(tables):
    (jt, _, _), (tt, _, _), extent, _ = tables
    tol = 4 * 2.0 ** -17 * extent
    for r in range(tt.shape[0]):
        np.testing.assert_allclose(tt[r], jt[r], rtol=0, atol=tol,
                                   err_msg=f"row {r}")
    np.testing.assert_allclose(tt[tct.CT_D], jt[tct.CT_D], rtol=0,
                               atol=1e-4)


def test_warm_rows_identical(tables):
    (_, _, jw), (_, _, tw), _, _ = tables
    assert np.count_nonzero(jw[0]) > 5
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("buckets", [(0, 1), (1, 1)])
def test_bucket_range_is_the_column_block(buckets):
    """buckets=(bucket0, nb) gives exactly the full table's blocks of
    those buckets (plain version), on a two-bucket rain with warm keys."""
    n = 192
    cfg = tscenes.rain_config(n).replace(contact_rebuild=1,
                                         contact_refresh_iters=0)
    ts = prepare_contacts(tscenes.mesh_rain(n, real_assets=False,
                                            device="cpu"), cfg)
    for _ in range(2):
        ts, _ = step_with_metrics(ts, cfg)
    order = tbp.sweep_order(ts, tbp.body_aabbs(ts))
    cand = tbp.pair_candidates(ts, cfg, order=order)
    geom = tct.unified_geom(ts, cfg, order, hulls=True)
    prev = (ts.contact_key, ts.contact_lam)
    full = tht.bucket_hull_contact_table(ts, cand, cfg, prev=prev, geom=geom)
    _, ccap, _ = tct.table_shape(n, cfg)
    _, cap, _ = tbp.bucket_shape(n, cfg)
    b0, nbl = buckets
    lanes = slice(b0 * cap, (b0 + nbl) * cap)
    cols = slice(b0 * ccap, (b0 + nbl) * ccap)
    part = tht.bucket_hull_contact_table(
        ts, PairCandidates(*[x[lanes] if x.dim() else x for x in cand]),
        cfg, prev=(prev[0][:, cols], prev[1][:, cols]), geom=geom,
        buckets=buckets)
    assert full[0][tct.CT_ACT, cols].sum() > 5
    assert torch.equal(part[0], full[0][:, cols])
    assert torch.equal(part[1], full[1][:, b0 * 128:(b0 + nbl) * 128])
    assert torch.equal(part[2], full[2][:, cols])
