"""The generic banded branch's contact list (ops/narrowphase.py
`banded_contacts`): its plain composition, which the fused CUDA launch
(csrc/narrowphase_banded.cu) is held to on the card, against the JAX
package's ground contacts and banded pair contacts on the CPU, at the
two-kernel pile's test sizes (tests/test_torch_pair_manifolds.py: 192
boxes, poses and rotations rounded to 16 significant bits for the JAX
kernel's bf16 splits); and the wrapper's refusals.

The JAX package on the CPU takes the generic body-major ground contacts
where the port takes the TPU route (slot-major corners), so the two lists
hold the same contacts in another order: the active contacts are compared
sorted by key (keys unique, counts equal, nothing cut at a capacity),
with their endpoint ids and rank rows identical and their f32 fields
within 2e-4 (tests/test_torch_pair_manifolds.py: f32 operation order
and the split reads).
"""

import numpy as np
import pytest
import torch

import jax

from physics_tpu.ops import narrowphase as jnp_
from physics_tpu_torch.ops import narrowphase as tnp
from physics_tpu_torch.ops.narrowphase_banded import (
    pair_manifolds_banded_plain,
)
from physics_tpu_torch.parallel.collectives import Shard

from tests.test_torch_pair_manifolds import (  # noqa: F401  (fixture)
    F32_TOL,
    N,
    _split_exact_rotations,
    scene,
)

F32_FIELDS = ("point", "normal", "depth", "friction", "restitution")


def _rank_of(order) -> torch.Tensor:
    order = torch.from_numpy(np.array(order)).long()
    rank = torch.empty_like(order, dtype=torch.int32)
    rank[order] = torch.arange(order.shape[0], dtype=torch.int32)
    return rank


def _jax_list(s, cand, cfg_j):
    """The JAX package's ground then pair contacts (concatenated)."""
    gc = jnp_.ground_contacts(s, jnp_.convex_data(s), cfg_j)
    pc = jax.jit(lambda c: jnp_._pair_contacts_boxes_pallas(s, c, cfg_j))(
        cand)
    both = jnp_.concat_contacts(gc, pc)
    return {f: np.asarray(getattr(both, f)) for f in tnp.Contacts._fields}


def _active_by_key(fields):
    act = fields["active"]
    key = fields["key"][act]
    idx = np.argsort(key, kind="stable")
    return {f: (v[..., act][..., idx] if v.ndim > 1 else v[act][idx])
            for f, v in fields.items()}


def test_plain_composition_matches_jax(scene, monkeypatch):
    (s, cand, order, cfg_j), (ts, tcand, geom, cfg_t) = scene
    _split_exact_rotations(monkeypatch)
    rank = _rank_of(order)
    tc, lo, rb, n_ground = tnp.banded_contacts(ts, cfg_t, rank, tcand, geom)
    kg = min(cfg_t.max_contacts_per_pair, 8)
    assert n_ground == kg * N
    assert lo.shape == rb.shape == tc.body_a.shape
    t = {f: getattr(tc, f).numpy() for f in tnp.Contacts._fields}
    j = _jax_list(s, cand, cfg_j)
    assert t["active"].sum() == j["active"].sum() > 250
    assert not t["key"][~t["active"]].any()
    ta, ja = _active_by_key(t), _active_by_key(j)
    assert np.unique(ta["key"]).size == ta["key"].size
    for f in ("key", "body_a", "body_b"):
        assert np.array_equal(ta[f], ja[f]), f
    for f in F32_FIELDS:
        np.testing.assert_allclose(ta[f], ja[f], rtol=0, atol=F32_TOL,
                                   err_msg=f)
    # the rank rows: the sweep rank of body_a, of body_b (−1: the ground)
    act = t["active"]
    r = rank.numpy()
    assert np.array_equal(lo.numpy()[act], r[t["body_a"][act]])
    assert np.array_equal(rb.numpy()[act],
                          np.where(t["body_b"][act] >= 0,
                                   r[t["body_b"][act]], -1))
    assert np.array_equal(rb.numpy()[:n_ground], np.full(n_ground, -1))


def test_shard_slices_make_the_whole(scene):
    """Under a 2-rank shard each rank's ground slice and chunked pair
    lanes hold the whole list's contacts: ground slices end to end, pair
    picks lane-sliced, ids, keys and rank rows identical."""
    _, (ts, tcand, geom, cfg_t) = scene
    rank = torch.arange(N, dtype=torch.int32)
    whole, lo, rb, ng = tnp.banded_contacts(ts, cfg_t, rank, tcand, geom)
    parts = [tnp.banded_contacts(ts, cfg_t, rank, tcand, geom,
                                 shard=Shard(None, r, 2)) for r in range(2)]
    p = tcand.body_a.shape[0]
    kk = (whole.body_a.shape[0] - ng) // p
    for f in ("body_a", "body_b", "key", "active"):
        w = getattr(whole, f)
        got_g = torch.cat([getattr(c, f)[:g] for c, _, _, g in parts])
        assert torch.equal(got_g, w[:ng]), f
        got_p = torch.stack([torch.cat([
            getattr(c, f)[g:].reshape(kk, -1)[s] for c, _, _, g in parts])
            for s in range(kk)]).reshape(-1)
        assert torch.equal(got_p, w[ng:]), f
    got_lo = torch.cat([x[1][:x[3]] for x in parts])
    assert torch.equal(got_lo, lo[:ng])
    got_rb = torch.cat([x[2][x[3]:].reshape(kk, -1)[0] for x in parts])
    assert torch.equal(got_rb, rb[ng:ng + p])


def test_empty_lane_rows():
    """The rows the plain version gives an empty lane (two zero bodies),
    which the kernel writes without running the manifold: all zero but
    the normal, −0."""
    geom = torch.zeros((48, 256))
    empty = torch.full((128,), -1, dtype=torch.int32)
    rows = pair_manifolds_banded_plain(geom, torch.zeros(1, dtype=torch.int32),
                                       empty, empty, tile=128, kk=4)
    normal = rows[20:23]
    assert not rows.any()
    assert torch.signbit(normal).all() and not torch.signbit(rows[:20]).any()
    assert not torch.signbit(rows[23:]).any()


def test_wrapper_refuses_other_devices_and_dtypes(scene):
    _, (ts, tcand, geom, cfg_t) = scene
    rank = torch.arange(N, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tnp.banded_contacts(ts, cfg_t, rank, tcand,
                            torch.empty(geom.shape, device="meta"))
    # the launch path checks every operand before it builds or launches
    with pytest.raises(ValueError, match="rank must be"):
        tnp._launch_kernel(ts, cfg_t, rank.long(), tcand, geom, None)
    with pytest.raises(ValueError, match="geom must be"):
        tnp._launch_kernel(ts, cfg_t, rank, tcand, geom.double(), None)
    bad = tcand._replace(mask=tcand.mask.to(torch.int32))
    with pytest.raises(ValueError, match="mask must be"):
        tnp._launch_kernel(ts, cfg_t, rank, bad, geom, None)
