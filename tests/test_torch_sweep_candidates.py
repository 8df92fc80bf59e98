"""The bucketed sweep candidates of physics_tpu_torch (the plain version of
the candidates mode of csrc/sweep.cu, `bucketed_candidates_plain`, which
compacts each bucket without a sort) against the JAX package's
`sweep_candidates_bucketed` (its segmented uint32 sort), at the shapes
where the compaction has edges: every field identical, the dead lanes
(the misses after each bucket's hits, slot 0 past block·k) and the
overflow count included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from physics_tpu.ops import broadphase as jbp
from physics_tpu_torch.ops import broadphase as tbp
from physics_tpu_torch.state import SHAPE_NONE, state_from_arrays

from tests.test_torch_config_scene import configs, dense_pile, jax_arrays

# case → (bodies, config overrides, non-collidable tail)
CASES = {
    "pile_256": (256, {}, 0),
    "n_not_a_multiple_of_block": (200, {}, 0),
    "block_k_below_cap": (96, {"bucket_block": 8, "sweep_window": 6,
                               "bucket_cap": 128}, 0),
    "saturated_bucket": (256, {"bucket_cap": 128}, 0),
    "window_edge": (256, {"sweep_window": 3, "bucket_cap": 384}, 0),
    "non_collidable_tail": (192, {}, 40),
}


def _scene(n, tail):
    js = dense_pile(n)
    if tail:
        stype = np.asarray(js.shapes.stype).copy()
        stype[-tail:] = SHAPE_NONE
        js = js.replace(shapes=js.shapes.replace(stype=jnp.asarray(stype)))
    return js


@pytest.mark.parametrize("case", list(CASES))
def test_bucketed_candidates_match_jax(case):
    n, overrides, tail = CASES[case]
    js = _scene(n, tail)
    cfg_j, cfg_t = configs(n)
    cfg_j, cfg_t = cfg_j.replace(**overrides), cfg_t.replace(**overrides)
    jc = jbp.pair_candidates(js, cfg_j)
    ts = state_from_arrays(jax_arrays(js), "cpu")
    aabbs = torch.from_numpy(np.array(jbp.body_aabbs(js)))
    tc = tbp.pair_candidates(ts, cfg_t, aabbs=aabbs)
    for name in ("body_a", "body_b", "mask", "rank_a", "rank_b",
                 "overflow"):
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, name
        assert np.array_equal(b, a), name

    # the edge each case is there for
    block, cap, nb = tbp.bucket_shape(n, cfg_t)
    k = min(cfg_t.sweep_window, n - 1)
    _, mask, last = tbp._sweep_masks(ts, aabbs, k)
    hits = torch.nn.functional.pad(mask, (0, 0, 0, nb * block - n)).reshape(
        nb, -1).sum(dim=1)
    dropped = int(torch.clamp(hits - cap, min=0).sum())
    assert int(tc.mask.sum()) > 50
    assert int(tc.overflow) == int(last.sum()) + dropped
    if case == "n_not_a_multiple_of_block":
        assert n % block
    if case == "block_k_below_cap":
        assert block * k < cap
        lanes = torch.arange(nb * cap) % cap
        pad = lanes >= block * k
        assert bool((tc.rank_a[pad] == torch.arange(nb).repeat_interleave(
            cap)[pad] * block).all())
    if case == "saturated_bucket":
        assert dropped > 0
    if case == "window_edge":
        assert int(last.sum()) > 0 and dropped == 0
    if case == "non_collidable_tail":
        assert set(tc.body_a[tc.mask].tolist()).isdisjoint(
            range(n - tail, n))
        order = tbp.sweep_order(ts, aabbs)
        assert sorted(order[-tail:].tolist()) == list(range(n - tail, n))
