"""The banded narrow phase of the two-kernel box pile: physics_tpu_torch's
plain versions (the CPU side of kernel csrc/narrowphase_banded.cu) against
the JAX package's functions called directly, its Pallas kernel in
interpret mode: `pair_manifolds_banded` (kernel 2.8), the slot-major pair
contacts built from its rows (`_pair_contacts_boxes_pallas`), and the box
ground corners (`_ground_contacts_boxes`, the TPU route, which the JAX
package on the CPU would not take by itself).

The scene is a contact-rich two-bucket pile (192 boxes) under the pile
config with the table off and the sizes of tests/test_contact_table.py's
two-kernel run: bucket_block 8, bucket_cap 128, pallas_tile 128, and
pallas_window 256, the narrowest window whose static tile span (up to 127
ranks of rounding, a bucket of 8 and the sweep's 48) fits at 192 bodies.

Inputs. The JAX kernel reads each lane's bodies through hi/lo bf16
splits, exact for values of 16 significant bits. Positions are rounded so
in the state, and the rotations the JAX wrapper derives from the
quaternions are rounded so while it traces (vec3c.quat_to_mat is wrapped
for the JAX calls alone); the port's geometry table gets the same rounded
rotation rows. Without that the split's 2⁻¹⁷ relative error moves a few
clip points of near-parallel edges by up to 3 mm, on slots whose activity
and source slot still agree.

Tolerances. Slot ids, body ids, keys and activity must be identical; the
f32 rows of active slots (and the normal, friction and restitution of
lanes with one) are held to 2e-4, what is left being f32 operation
order; inactive slots carry no contact. The ground corners involve no
split: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.maths import vec3c as jv3
from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import narrowphase as jnp_
from physics_tpu.ops.narrowphase_pallas import pair_manifolds_banded as jpm
from physics_tpu_torch.ops import narrowphase as tnp
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.ops.contact_table import unified_geom
from physics_tpu_torch.ops.narrowphase_banded import (
    body_table_width,
    pair_manifolds_banded,
)
from physics_tpu_torch.state import state_from_arrays

from tests.test_torch_config_scene import (
    bf16_pair_exact,
    configs,
    dense_pile,
    jax_arrays,
)

N = 192
F32_TOL = 2e-4
INT_FIELDS = ("body_a", "body_b", "active", "key")


def np_configs(n: int):
    """The two-kernel pile config of both packages at test sizes."""
    kw = dict(contact_table=False, bucket_block=8, bucket_cap=128,
              pallas_tile=128, pallas_window=256)
    cfg_j, cfg_t = configs(n)
    return cfg_j.replace(**kw), cfg_t.replace(**kw)


def _round16(x):
    """bf16_pair_exact inside a JAX trace."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    return jax.lax.bitcast_convert_type(
        (u + jnp.uint32(0x80)) & jnp.uint32(0xFFFFFF00), jnp.float32)


def _split_exact_rotations(monkeypatch):
    quat_to_mat = jv3.quat_to_mat
    monkeypatch.setattr(jv3, "quat_to_mat", lambda q: tuple(
        _round16(x) for x in quat_to_mat(q)))


@pytest.fixture(scope="module")
def scene():
    cfg_j, cfg_t = np_configs(N)
    s = dense_pile(N)
    s = s.replace(pos=jnp.asarray(bf16_pair_exact(s.pos)))
    order = jbp.sweep_order(s, jbp.body_aabbs(s))
    cand = jbp.pair_candidates(s, cfg_j)
    ts = state_from_arrays(jax_arrays(s), "cpu")
    tcand = PairCandidates(*[torch.from_numpy(np.array(x)) for x in cand])
    torder = torch.from_numpy(np.array(order))
    geom = unified_geom(ts, cfg_t, torder, npad=body_table_width(N, cfg_t))
    geom[27:36] = torch.from_numpy(bf16_pair_exact(geom[27:36]))
    return (s, cand, order, cfg_j), (ts, tcand, geom, cfg_t)


def _check_rows(trows, jrows, pp, kk):
    """The port's rows against the JAX kernel's; returns the active
    slots of the first pick."""
    assert kk == 4 and trows.shape == (5 * kk + 7, pp)
    assert jrows.shape == (32, pp) and not jrows[5 * kk + 7:].any()
    live = np.zeros(pp, bool)
    for p in range(kk):
        act = jrows[5 * p + 3] > 0
        assert np.array_equal(trows[5 * p + 3] > 0, act), p  # activity
        assert np.array_equal(trows[5 * p + 4], jrows[5 * p + 4]), p
        np.testing.assert_allclose(
            trows[5 * p:5 * p + 4, act], jrows[5 * p:5 * p + 4, act],
            rtol=0, atol=F32_TOL, err_msg=f"pick {p}")
        live |= act
    r0 = 5 * kk
    assert np.array_equal(trows[r0 + 5:r0 + 7], jrows[r0 + 5:r0 + 7])
    np.testing.assert_allclose(trows[r0:r0 + 5, live],
                               jrows[r0:r0 + 5, live], rtol=0, atol=F32_TOL)
    return int((jrows[3] > 0).sum())


def test_pair_manifold_rows_match(scene, monkeypatch):
    (s, cand, order, cfg_j), (ts, tcand, geom, cfg_t) = scene
    _split_exact_rotations(monkeypatch)
    jrows = np.asarray(jax.jit(
        lambda c: jpm(s, c, cfg_j, order)[0])(cand))
    trows, pp, kk = pair_manifolds_banded(ts, tcand, cfg_t, geom)
    assert _check_rows(trows.numpy(), jrows, pp, kk) > 200  # contact-rich


@pytest.mark.parametrize("half", [0, 1])
def test_pair_manifold_rows_chunked_match(scene, monkeypatch, half):
    """Chunked mode (one rank's half of the candidate lanes in a
    two-rank step): window bases from each tile's lowest live rank, in
    both packages."""
    (s, cand, order, cfg_j), (ts, tcand, geom, cfg_t) = scene
    _split_exact_rotations(monkeypatch)
    p = cand.body_a.shape[0] // 2
    cut = slice(half * p, (half + 1) * p)
    jcand = jbp.PairCandidates(*[x[cut] if np.ndim(x) else x for x in cand])
    tc = PairCandidates(*[x[cut] if x.dim() else x for x in tcand])
    jrows = np.asarray(jax.jit(
        lambda c: jpm(s, c, cfg_j, order, chunked=True)[0])(jcand))
    trows, pp, kk = pair_manifolds_banded(ts, tc, cfg_t, geom, chunked=True)
    assert _check_rows(trows.numpy(), jrows, pp, kk) > 80


def _check_contacts(tc, jc, f32_tol):
    act = np.asarray(jc.active)
    for f in tnp.Contacts._fields:
        t, j = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert t.shape == j.shape, f
        if f in INT_FIELDS:
            assert np.array_equal(t, j), f
        else:
            np.testing.assert_allclose(t[..., act], j[..., act], rtol=0,
                                       atol=f32_tol, err_msg=f)


def test_pair_contacts_match(scene, monkeypatch):
    (s, cand, _, cfg_j), (ts, tcand, geom, cfg_t) = scene
    _split_exact_rotations(monkeypatch)
    jc = jax.jit(lambda c: jnp_._pair_contacts_boxes_pallas(s, c, cfg_j))(
        cand)
    tc = tnp.pair_contacts(ts, tcand, cfg_t, geom)
    _check_contacts(tc, jc, F32_TOL)
    assert int(np.asarray(jc.active).sum()) > 200


def test_ground_contacts_match(scene):
    (s, _, _, cfg_j), (ts, _, _, cfg_t) = scene
    jc = jnp_._ground_contacts_boxes(s, cfg_j)
    tc = tnp.ground_contacts(ts, cfg_t)
    _check_contacts(tc, jc, 1e-6)
    assert int(np.asarray(jc.active).sum()) > 50


def test_tile_span_beyond_window_raises(scene):
    """A bucketed tile whose rank span exceeds pallas_window is refused
    before anything runs, in both packages."""
    (s, cand, order, cfg_j), (ts, tcand, _, cfg_t) = scene
    with pytest.raises(ValueError, match="rank span"):
        jpm(s, cand, cfg_j.replace(pallas_window=128), order)
    narrow = cfg_t.replace(pallas_window=128)
    geom = unified_geom(ts, narrow, torch.arange(N, dtype=torch.int32),
                        npad=body_table_width(N, narrow))
    with pytest.raises(ValueError, match="rank span"):
        pair_manifolds_banded(ts, tcand, narrow, geom)
