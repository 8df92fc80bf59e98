"""The generic hull path's modules: physics_tpu_torch (plain versions on
the CPU) against the JAX package, eagerly, on tests/test_hullhull.py's
tight grid of 24 randomly oriented, overlapping hulls (one bevelled cube
type, and the 3-type library of mesh_rain_mixed), caps widened as there.

  - the flat sweep's candidates (`sweep_candidates`) and `compact_pairs`
    at caps below, at and above the live count: every lane and the
    overflow identical;
  - `hull_obb_prefilter`, one type (H = 1) and three (H = 3, nine ordered
    type-pair segments): lanes, mask and dropped survivors identical;
  - `shared_hull_manifolds_sm` on the live lanes: every field within
    1e-5 (f32 products summed in another order);
  - `_ground_contacts_hulls_fast` (the grid lowered through the ground)
    and `_pair_contacts_hulls_fast`: keys identical lane for lane,
    points, normals and depths within 1e-5;
  - the prefiltered pair contacts' active keys equal to the unfiltered
    ones (the prefilter drops only OBB-separated pairs), as
    tests/test_hullhull.py `test_hull_obb_prefilter` asserts in JAX;
  - `hull_tables`, the coefficient tables both hull paths read: kept
    while the library is unchanged, rebuilt after an in-place edit or a
    replaced field (the port's own, no JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from physics_tpu import scenes as jscenes
from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import hullhull_batched as jhh
from physics_tpu.ops import narrowphase as jnph

from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.ops import broadphase as tbp
from physics_tpu_torch.ops import hullhull_batched as thh
from physics_tpu_torch.ops import narrowphase as tnph
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.state import state_from_arrays

from tests.test_torch_config_scene import jax_arrays

N = 24
ATOL = 1e-5


def tight_grid(n_types: int, drop: float = 0.0):
    """tests/test_hullhull.py's contact-rich state without stepping: the
    rain's hulls in a 0.72-spaced grid, jittered, randomly oriented;
    `drop` lowers it through the ground."""
    if n_types == 1:
        js = jscenes.mesh_rain(N, seed=0, real_assets=False)
    else:
        js = jscenes.mesh_rain_mixed(N, real_assets=False, n_types=n_types)
    rng = np.random.default_rng(3)
    g = np.stack(np.meshgrid(*[np.arange(3) * 0.72] * 2, np.arange(3) * 0.72,
                             indexing="ij"), -1).reshape(-1, 3)[:N]
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = (g + rng.uniform(-0.05, 0.05, (N, 3))).astype(np.float32)
    pos[:, 1] -= drop
    js = js.replace(pos=jnp.asarray(pos), quat=jnp.asarray(q))
    return js, state_from_arrays(jax_arrays(js), "cpu")


def config(**over):
    # the synthetic grid is far denser than a settled rain: capacities
    # widened so that nothing overflows unless a test cuts them
    return tscenes.rain_xla_config(N).replace(**{
        "max_contacts": 768, "max_pair_candidates": 768,
        "hull_prefilter_cap": 768, **over})


def jcfg(cfg):
    """The JAX package's SimConfig with the port config's values, z_bf16
    off."""
    vals = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return jscenes.rain_xla_config(N).replace(**{**vals, "z_bf16": False})


def to_torch(cand) -> PairCandidates:
    return PairCandidates(*[torch.from_numpy(np.array(x)) for x in cand])


def cand_equal(tc, jc, what):
    for f in PairCandidates._fields:
        got, want = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert got.shape == want.shape, (what, f)
        assert np.array_equal(got, want), (what, f)


@pytest.fixture(scope="module")
def grids():
    return {h: tight_grid(h) for h in (1, 3)}


@pytest.fixture(scope="module")
def flat(grids):
    """The flat sweep's uncompacted candidates of the one-type grid."""
    js, ts = grids[1]
    cfg = config()
    jc = jbp.sweep_candidates(js, jbp.body_aabbs(js), cfg.sweep_window)
    tc = tbp.sweep_candidates(ts, tbp.body_aabbs(ts), cfg.sweep_window)
    return jc, tc


def test_sweep_candidates_identical(flat):
    jc, tc = flat
    cand_equal(tc, jc, "flat sweep")
    assert tc.body_a.shape == (N * (N - 1),)
    assert int(tc.mask.sum()) > 60


@pytest.mark.parametrize("cap", [40, 96, 552, 768])
def test_compact_pairs_identical(flat, cap):
    jc, tc = flat
    jo = jbp.compact_pairs(jc, cap)
    to = tbp.compact_pairs(tc, cap)
    cand_equal(to, jo, f"compact_pairs({cap})")
    live = int(tc.mask.sum())
    assert int(to.overflow) == int(tc.overflow) + max(live - cap, 0)
    if cap < tc.mask.numel():
        # the kept actives are the first `cap` in emission order
        idx = np.flatnonzero(tc.mask.numpy())[:cap]
        assert np.array_equal(to.body_b.numpy()[:len(idx)],
                              tc.body_b.numpy()[idx])
    else:
        assert to is tc             # nothing to compact


def test_pair_candidates_flat(grids):
    """pair_candidates with pair_buckets off: the flat sweep, compacted."""
    js, ts = grids[1]
    cfg = config(max_pair_candidates=96)
    cand_equal(tbp.pair_candidates(ts, cfg),
               jbp.pair_candidates(js, jcfg(cfg)), "pair_candidates")
    with pytest.raises(NotImplementedError, match="1.13.5"):
        tbp.pair_candidates(ts, cfg.replace(broadphase="allpairs"))


@pytest.mark.parametrize("types,cap2", [(1, 48), (1, 512), (3, 96),
                                        (3, 768)])
def test_obb_prefilter_identical(grids, types, cap2):
    js, ts = grids[types]
    cfg = config()
    jc = jbp.pair_candidates(js, jcfg(cfg))
    jo, jovf = jnph.hull_obb_prefilter(js, jc, cap2)
    to, tovf = tnph.hull_obb_prefilter(ts, to_torch(jc), cap2)
    cand_equal(to, jo, f"prefilter H={types} cap2={cap2}")
    assert int(tovf) == int(jovf)
    assert int(to.mask.sum()) > 10
    if cap2 == 48:
        assert int(tovf) > 0        # the cut is counted


@pytest.fixture(scope="module")
def prefiltered(grids):
    """{H: (JAX candidates, port candidates)} after the prefilter."""
    out = {}
    for h, (js, ts) in grids.items():
        cfg = config()
        jc, _ = jnph.hull_obb_prefilter(
            js, jbp.pair_candidates(js, jcfg(cfg)), cfg.hull_prefilter_cap)
        out[h] = (jc, to_torch(jc))
    return out


def manifolds_close(tm, jm, live, what):
    for f in thh.SharedManifoldSM._fields:
        got, want = getattr(tm, f), getattr(jm, f)
        if isinstance(got, tuple):
            got = torch.stack(got)
            want = jnp.stack(want)
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, (what, f)
        np.testing.assert_allclose(got[..., live], want[..., live], rtol=0,
                                   atol=ATOL, err_msg=f"{what} {f}")


def test_shared_manifolds_within_tolerance(grids, prefiltered):
    js, ts = grids[1]
    jc, tc = prefiltered[1]
    jm = jhh.shared_hull_manifolds_sm(js, jc, jcfg(config()))
    tm = thh.shared_hull_manifolds_sm(ts, tc)
    live = tc.mask.numpy()
    manifolds_close(tm, jm, live, "one type")
    assert (torch.stack(tm.depth)[:, live] > 0).sum() > 40


def test_shared_manifolds_type_pair(grids):
    """A cross-type pair's tables (A the cube, B the wedge): every lane
    of the grid's cube-wedge candidates."""
    js, ts = grids[3]
    jc = jbp.pair_candidates(js, jcfg(config()))
    ht = np.asarray(js.shapes.hull_index)
    keep = (np.asarray(jc.mask) & (ht[np.asarray(jc.body_a)] == 0)
            & (ht[np.asarray(jc.body_b)] == 2))
    sel = np.flatnonzero(keep)
    assert sel.size >= 5
    jc = type(jc)(*[x if np.ndim(x) == 0 else jnp.asarray(np.asarray(x)[sel])
                    for x in jc])
    jm = jhh.shared_hull_manifolds_sm(js, jc, jcfg(config()), types=(0, 2))
    tm = thh.shared_hull_manifolds_sm(ts, to_torch(jc), (0, 2))
    manifolds_close(tm, jm, np.ones(sel.size, bool), "types (0, 2)")


def contacts_close(tc, jc, what, min_active):
    tk, jk = tc.key.numpy(), np.asarray(jc.key)
    assert np.array_equal(tk, jk), what
    assert np.array_equal(tc.active.numpy(), np.asarray(jc.active)), what
    assert int((tk != 0).sum()) >= min_active, what
    for f in ("body_a", "body_b"):
        assert np.array_equal(getattr(tc, f).numpy(),
                              np.asarray(getattr(jc, f))), (what, f)
    for f in ("point", "normal", "depth", "friction", "restitution"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=0,
                                   atol=ATOL, err_msg=f"{what} {f}")


@pytest.mark.parametrize("types", [1, 3])
def test_ground_contacts_identical(types):
    js, ts = tight_grid(types, drop=0.45)
    cfg = config()
    contacts_close(tnph.ground_contacts(ts, cfg),
                   jnph._ground_contacts_hulls_fast(js, jcfg(cfg)),
                   f"ground H={types}", 10)


@pytest.mark.parametrize("types", [1, 3])
def test_pair_contacts_identical(grids, prefiltered, types):
    js, ts = grids[types]
    jc, tc = prefiltered[types]
    cfg = config()
    contacts_close(tnph.pair_contacts(ts, tc, cfg),
                   jnph._pair_contacts_hulls_fast(js, jc, jcfg(cfg)),
                   f"pairs H={types}", 20)


def test_prefilter_keeps_the_contact_set(grids):
    """The port's prefiltered pair contacts carry the same active keys
    and depths as the unfiltered candidates'."""
    _, ts = grids[1]
    cfg = config()
    cand = tbp.pair_candidates(ts, cfg)
    cand2, ovf = tnph.hull_obb_prefilter(ts, cand, 512)
    assert int(ovf) == 0
    assert int(cand2.mask.sum()) < int(cand.mask.sum())
    full = tnph.pair_contacts(ts, cand, cfg)
    pre = tnph.pair_contacts(ts, cand2, cfg)
    kf, kp = full.key.numpy(), pre.key.numpy()
    assert (kf != 0).sum() > 20
    assert sorted(kf[kf != 0].tolist()) == sorted(kp[kp != 0].tolist())
    np.testing.assert_allclose(np.sort(full.depth.numpy()[kf != 0]),
                               np.sort(pre.depth.numpy()[kp != 0]),
                               rtol=0, atol=1e-6)
    m2 = cand2.mask.numpy()
    assert np.all(cand2.rank_a.numpy()[m2] < cand2.rank_b.numpy()[m2])


def test_hull_tables_follow_the_library(grids):
    """hull_tables keeps each type pair's tables on the HullSet: the same
    tensors while the library is unchanged, rebuilt (equal to
    build_hull_tables) after an in-place edit or a replaced field."""
    _, ts = grids[3]
    hs = dataclasses.replace(ts.hulls, **{
        f.name: getattr(ts.hulls, f.name).clone()
        for f in dataclasses.fields(ts.hulls)})
    t01 = thh.hull_tables(hs, 0, 1)
    assert thh.hull_tables(hs, 0, 1) is t01
    assert thh.hull_tables(hs, 1, 0) is not t01
    c_av = t01.c_av.clone()
    hs.verts.mul_(2.0)
    t2 = thh.hull_tables(hs, 0, 1)
    assert t2 is not t01 and not torch.equal(t2.c_av, c_av)
    hs.face_offsets = hs.face_offsets * 1.5
    t3 = thh.hull_tables(hs, 0, 1)
    assert t3 is not t2
    for a, b in zip(t3, thh.build_hull_tables(hs, 0, 1)):
        assert torch.equal(a, b)
