"""The hull rain's host side and tables: physics_tpu_torch against
physics_tpu on the same scenes — the scene arrays (HullSet included), the
rain config, the hull bounding-sphere AABBs, the unified geometry table
in hull mode, the per-type-pair SAT coefficient tables and the dispatch
predicates, for libraries of 1, 2 and 3 hull types.

Tolerances: scene arrays and integer-valued rows identical; float tables
1e-6 (the same f32 expressions; XLA may associate a 3-term sum
differently).
"""

import dataclasses

import numpy as np
import pytest
import torch

from physics_tpu import scenes as jscenes
from physics_tpu.engine import prepare_contacts as jax_prepare
from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu.ops import hull_table as jht
from physics_tpu.ops import hullhull_batched as jhb
from physics_tpu.solver import contacts as jcontacts

from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import prepare_contacts
from physics_tpu_torch.ops import broadphase as tbp
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops import hull_table as tht
from physics_tpu_torch.ops import hullhull_batched as thb
from physics_tpu_torch.solver import contacts as tcontacts
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import jax_arrays

N = 150
LIBRARIES = [1, 2, 3]


def _scenes(types: int, n: int = N):
    """(JAX state, port state) of the same rain: the bevelled cubes for
    one type, else the mixed library of `types` hulls."""
    if types == 1:
        return (jscenes.mesh_rain(n, real_assets=False),
                tscenes.mesh_rain(n, real_assets=False, device="cpu"))
    return (jscenes.mesh_rain_mixed(n, real_assets=False, n_types=types),
            tscenes.mesh_rain_mixed(n, real_assets=False, n_types=types,
                                    device="cpu"))


@pytest.mark.parametrize("types", LIBRARIES)
def test_rain_arrays_identical(types):
    js, ts = _scenes(types)
    ja, ta = jax_arrays(js), to_numpy(ts)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        assert ta[k].shape == ja[k].shape, k
        assert np.array_equal(ta[k], ja[k]), k
    assert ta["hulls.verts"].shape[0] == types


@pytest.mark.parametrize("n", [128, 1024])
def test_rain_config_matches(n):
    assert (dataclasses.asdict(tscenes.rain_config(n))
            == dataclasses.asdict(jscenes.rain_config(n)))


@pytest.mark.parametrize("types", LIBRARIES)
def test_hull_aabbs_and_geometry_match(types):
    """Bounding-sphere AABBs, the sweep order, and the hull-mode unified
    geometry table (local-AABB halves, is_hull·(1 + type), OBB centre)."""
    js, ts = _scenes(types)
    ja = np.asarray(jbp.body_aabbs(js))
    ta = tbp.body_aabbs(ts).numpy()
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)
    order = jbp.sweep_order(js, jbp.body_aabbs(js))
    assert np.array_equal(tbp.sweep_order(ts, tbp.body_aabbs(ts)).numpy(),
                          np.asarray(order))
    cfg_j, cfg_t = jscenes.rain_config(N), tscenes.rain_config(N)
    jg = np.asarray(jct.unified_geom(js, cfg_j, order, hulls=True))
    tg = tct.unified_geom(ts, cfg_t, torch.from_numpy(np.array(order)),
                          hulls=True).numpy()
    assert tg.shape == jg.shape
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    for r in (24 + 17, 24 + 18, 24 + 19):      # movable, id, 1 + type
        assert np.array_equal(tg[r], jg[r]), r
    assert set(np.unique(tg[24 + 19, :N])) == set(range(1, types + 1))


@pytest.mark.parametrize("types", LIBRARIES)
def test_hull_tables_match(types):
    js, ts = _scenes(types, 8 * types)
    for ia in range(types):
        for ib in range(types):
            jt = jhb.build_hull_tables(js.hulls, ia, ib)
            tt = thb.build_hull_tables(ts.hulls, ia, ib)
            for name in jt._fields:
                a = np.asarray(getattr(jt, name))
                b = getattr(tt, name).numpy()
                assert a.shape == b.shape and a.dtype == b.dtype, name
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name} ({ia}, {ib})")


@pytest.mark.parametrize("types", LIBRARIES)
def test_hull_coef_multi_matches(types):
    js, ts = _scenes(types, 8 * types)
    jc, jdm, jh = jht.build_hull_coef_multi(js)
    tc, tdm, th = tht.build_hull_coef_multi(ts)
    assert tuple(tdm) == tuple(jdm) and th == jh == types
    assert tuple(tht.hull_dims(ts.hulls)) == tuple(jht.hull_dims(js.hulls))
    assert tht.hull_slots(ts.hulls) == jht.hull_slots(js.hulls)
    for name in jc._fields:
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
    # the kernel's edge indices are the one-hot rows of c48
    tcoef = tht.hull_table_coef(ts)
    assert tht.hull_table_coef(ts) is tcoef          # built once per HullSet
    c48 = tc.c48.numpy()
    for p in range(types * types):
        for s in range(4):
            rows = c48[p, s * tdm.e2p:(s + 1) * tdm.e2p]
            want = np.where(rows.max(axis=1) > 0, rows.argmax(axis=1), -1)
            assert np.array_equal(tcoef.eidx[p, s].numpy(), want), (p, s)


@pytest.mark.parametrize("types", LIBRARIES)
def test_dispatch_and_prepare_match(types):
    """hull_table_path / anchored_path / fused_integration decide as in
    the JAX package, and prepare_contacts allocates the same buffers."""
    js, ts = _scenes(types, 64)
    for cfg_j in (jscenes.rain_config(64),
                  jscenes.rain_config(64).replace(hull_table=False),
                  jscenes.rain_config(64).replace(contact_rebuild=1),
                  jscenes.pile_config(64)):
        cfg_t = tscenes.rain_config(64).replace(
            **{f.name: getattr(cfg_j, f.name)
               for f in dataclasses.fields(cfg_j)})
        for fn in ("hull_table_path", "anchored_path", "fused_integration"):
            assert (getattr(tcontacts, fn)(ts, cfg_t)
                    == getattr(jcontacts, fn)(js, cfg_j)), (fn, cfg_j)
    cfg_j, cfg_t = jscenes.rain_config(64), tscenes.rain_config(64)
    ja = jax_arrays(jax_prepare(js, cfg_j.replace(z_bf16=False)))
    ta = to_numpy(prepare_contacts(state_from_arrays(jax_arrays(js), "cpu"),
                                   cfg_t))
    for k in ("contact_key", "contact_lam", "contact_table",
              "contact_order", "contact_meta", "contact_ref"):
        assert ta[k].shape == ja[k].shape, k
        assert np.array_equal(ta[k], ja[k]), k
