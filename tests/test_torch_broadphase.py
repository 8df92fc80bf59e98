"""physics_tpu_torch's sweep broad phase against physics_tpu's (its XLA
branch, which is what the JAX package runs off the TPU): AABBs, the
stable sort order, the sweep-window masks (the plain version of kernel
ops/sweep_kernel.py) and the bucketed candidates. Integer outputs and
overflow counts must be identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from physics_tpu.ops import broadphase as jbp
from physics_tpu_torch.ops import broadphase as tbp
from physics_tpu_torch.ops.sweep_kernel import sweep_window_masks
from physics_tpu_torch.state import SHAPE_NONE, state_from_arrays

from tests.test_torch_config_scene import configs, dense_pile, jax_arrays


def _with_ghosts(state, every: int = 5):
    """Every `every`-th body made non-collidable (SHAPE_NONE): their sort
    keys tie at +inf, so the rank of every one of them depends on the
    sort being stable."""
    stype = np.asarray(state.shapes.stype).copy()
    stype[::every] = SHAPE_NONE
    return state.replace(shapes=state.shapes.replace(
        stype=jnp.asarray(stype)))


def _scenes():
    base = dense_pile()
    return {"pile": base, "ghosts": _with_ghosts(base)}


@pytest.mark.parametrize("scene", ["pile", "ghosts"])
def test_aabbs_and_stable_sort_order(scene):
    js = _scenes()[scene]
    ts = state_from_arrays(jax_arrays(js), "cpu")
    ja = jbp.body_aabbs(js)
    ta = tbp.body_aabbs(ts)
    # |R|·h as a 3-term sum: a few ulps apart between XLA's einsum and
    # PyTorch's sum
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    jo = np.asarray(jbp.sweep_order(js, ja))
    # same AABBs on both sides, so the order must be identical, ties
    # (the +inf keys of non-collidable bodies) included
    to = tbp.sweep_order(ts, torch.from_numpy(np.array(ja))).numpy()
    assert np.array_equal(to, jo)
    if scene == "ghosts":
        assert np.array_equal(to[-39:], np.arange(0, 192, 5))


@pytest.mark.parametrize("scene", ["pile", "ghosts"])
@pytest.mark.parametrize("k", [1, 12, 48])
def test_sweep_masks_identical(scene, k):
    js = _scenes()[scene]
    ts = state_from_arrays(jax_arrays(js), "cpu")
    aabbs = jbp.body_aabbs(js)
    jo, jm, jl = map(np.asarray, jbp._sweep_masks(js, aabbs, k))
    to, tm, tl = tbp._sweep_masks(ts, torch.from_numpy(np.array(aabbs)),
                                  k)
    assert np.array_equal(to.numpy(), jo)
    assert tm.dtype == torch.bool and tm.shape == (192, k)
    assert np.array_equal(tm.numpy(), jm)
    assert np.array_equal(tl.numpy(), jl)
    assert jm.sum() > 0


def test_sweep_masks_checks_inputs():
    aabb = torch.zeros((8, 2, 3))
    coll = torch.ones((8,), dtype=torch.bool)
    with pytest.raises(ValueError):
        sweep_window_masks(aabb, coll, 8)
    with pytest.raises(ValueError):
        sweep_window_masks(aabb.double(), coll, 2)
    with pytest.raises(ValueError):
        sweep_window_masks(aabb, coll.int(), 2)


@pytest.mark.parametrize("scene,overrides", [
    ("pile", {}),
    ("ghosts", {}),
    # a window and a bucket cap too small for the scene: both overflow
    # counters must fire, identically
    ("pile", {"sweep_window": 6, "bucket_cap": 128,
              "max_pair_candidates": 256}),
])
def test_bucketed_candidates_identical(scene, overrides):
    js = _scenes()[scene]
    cfg_j, cfg_t = configs(192)
    cfg_j, cfg_t = cfg_j.replace(**overrides), cfg_t.replace(**overrides)
    ts = state_from_arrays(jax_arrays(js), "cpu")
    jc = jbp.pair_candidates(js, cfg_j)
    aabbs = torch.from_numpy(np.array(jbp.body_aabbs(js)))
    tc = tbp.pair_candidates(ts, cfg_t, aabbs=aabbs)
    assert tbp.bucket_shape(192, cfg_t) == jbp.bucket_shape(192, cfg_j)
    for name in ("body_a", "body_b", "mask", "rank_a", "rank_b",
                 "overflow"):
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert b.dtype == a.dtype, name
        assert np.array_equal(b, a), name
    assert int(tc.mask.sum()) > 100
    if overrides:
        assert int(tc.overflow) > 0
    elif scene == "pile":
        # (with ghosts the window-edge counter also counts x-overlaps with
        # non-collidable neighbours, as the JAX package does)
        assert int(tc.overflow) == 0
