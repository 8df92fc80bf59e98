"""The contact table's candidate-free modes: physics_tpu_torch's plain
version (the CPU side of kernel csrc/contact_table.cu) against the JAX
package's Pallas kernel in interpret mode.

  * the in-kernel broad phase on the sweep order (cand=None): a
    contact-rich two-bucket pile whose narrow window (sweep_window 4)
    leaves ranks overlapping past its edge (meta column 3), with the cap2
    prefilter behind the raw compaction;
  * packed envs (broadphase="env_blocks", same-env pairs under the
    identity order) with the per-bucket gate: 32 envs of 8 boxes (two
    buckets), every bucket fired, then gates [1, 0] and [0, 1] over a
    persisted table, the fired bucket recomputed from moved bodies.

The capacities are cut (2 contacts a pair, 256 lanes and 256 slots a
bucket) so the interpreted kernels compile in seconds; the modes'
control flow is the full one. Tolerances as tests/test_torch_contact_
table.py: geometry and warm impulses rounded to 16 significant bits (the
JAX kernel's hi/lo bf16 split carries them exactly); keys, activity,
ranks, meta and warm rows identical; f32 rows within 4·2⁻¹⁷ × the scene
extent.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig as JaxConfig
from physics_tpu.envs import pack_envs
from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu.scenes import random_env
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.state import state_from_arrays

from tests.test_torch_config_scene import (
    bf16_pair_exact,
    configs,
    dense_pile,
    jax_arrays,
)

EXACT_ROWS = [tct.CT_ACT, tct.CT_KL, tct.CT_KH, tct.CT_KSGN, tct.CT_RA,
              tct.CT_RB1, tct.CT_KS, tct.CT_MU, tct.CT_REST]
SMALL = dict(max_contacts_per_pair=2, bucket_ccap=256)


def to_jax_config(cfg):
    """The JAX SimConfig with the port config's fields (f32 z movement)."""
    return JaxConfig(**dataclasses.asdict(cfg)).replace(z_bf16=False)


def compare(j, t, extent):
    (jt, jm, jw), (tt, tm, tw) = j, [x.numpy() for x in t]
    for r in EXACT_ROWS:
        assert np.array_equal(tt[r], jt[r]), r
    assert np.array_equal(tm, jm)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=4 * 2.0 ** -17 * extent)


def test_inkernel_broadphase_on_the_sweep_order():
    n = 192
    _, cfg_t = configs(n)
    cfg_t = cfg_t.replace(sweep_window=4, bucket_cap2=128, **SMALL)
    cfg_j = to_jax_config(cfg_t)
    s = dense_pile(n)
    order = jbp.sweep_order(s, jbp.body_aabbs(s))
    geom = bf16_pair_exact(jct.unified_geom(s, cfg_j, order))
    nb, ccap, cp = jct.table_shape(n, cfg_j)
    run = jax.jit(lambda pk, pl: jct.bucket_contact_table(
        s, None, cfg_j, order, prev=(pk, pl), geom=jnp.asarray(geom)))
    t0, _, _ = run(jnp.zeros((2, cp), jnp.int32),
                   jnp.zeros((3, cp), jnp.float32))
    rng = np.random.default_rng(7)
    keys = np.asarray(jct.table_keys(t0))
    keys = keys * (rng.random(cp) > 0.33)[None, :].astype(np.int32)
    lam = bf16_pair_exact(rng.uniform(0.0, 1.0, (3, cp)))
    jout = [np.asarray(x) for x in run(jnp.asarray(keys), jnp.asarray(lam))]

    ts = state_from_arrays(jax_arrays(s), "cpu")
    tout = tct.bucket_contact_table(
        ts, None, cfg_t, prev=(torch.from_numpy(keys), torch.from_numpy(lam)),
        geom=torch.from_numpy(geom))
    meta = jout[1][0].reshape(nb, 128)
    assert jout[0][tct.CT_ACT].sum() > 200
    assert meta[:, 3].sum() > 0                  # window-edge ranks
    assert np.count_nonzero(jout[2][0]) > 50     # warm-started slots
    compare(jout, tout, float(np.abs(geom[0:3, :n]).max()))


@pytest.fixture(scope="module")
def packed():
    """32 packed envs of 8 boxes: the JAX state, both configs, the JAX
    gated table kernel (jitted once) and the port's state."""
    e, k = 32, 8
    cfg_t = tscenes.packed_env_config(e, k).replace(bucket_cap=256, **SMALL)
    cfg_j = to_jax_config(cfg_t)
    base = random_env(0, k)
    offsets = np.random.default_rng(1).uniform(-1, 1, (e, 1, 3))
    s = pack_envs(jax.vmap(lambda o: base.replace(pos=base.pos + o))(
        jnp.asarray(offsets.astype(np.float32))))
    run = jax.jit(lambda g, gate, pt, pk, pl: jct.bucket_contact_table(
        s, None, cfg_j, None, prev=(pk, pl), geom=g, gate=(gate, pt)))
    return s, cfg_j, cfg_t, run, state_from_arrays(jax_arrays(s), "cpu")


def test_packed_envs_and_gate(packed):
    s, cfg_j, cfg_t, run, ts = packed
    n = s.num_bodies
    nb, ccap, cp = jct.table_shape(n, cfg_j)
    geom = bf16_pair_exact(jct.unified_geom(s, cfg_j, None))
    extent = float(np.abs(geom[0:3, :n]).max())
    zeros = (np.zeros((2, cp), np.int32), np.zeros((3, cp), np.float32))

    def both(g, gate, persisted, prev):
        jout = [np.asarray(x) for x in run(
            jnp.asarray(g), jnp.asarray(np.array(gate, np.int32)),
            jnp.asarray(persisted), *map(jnp.asarray, prev))]
        tout = tct.bucket_contact_table(
            ts, None, cfg_t, prev=tuple(map(torch.from_numpy, prev)),
            geom=torch.from_numpy(g), gate=(torch.tensor(gate),
                                            torch.from_numpy(persisted)))
        compare(jout, tout, extent)
        return jout

    # every bucket fired: the packed rebuild's table (same-env pairs only)
    table, meta, _ = both(geom, [1, 1], np.zeros((32, cp), np.float32),
                          zeros)
    act = table[tct.CT_ACT] > 0
    pair = act & (table[tct.CT_KSGN] == 0)
    assert pair.sum() > 20 and (act & ~pair).sum() > 5
    # body id = rank: both ends of every pair in one env of 8
    assert np.all(table[tct.CT_KH][pair] // 8 == table[tct.CT_KL][pair] // 8)
    assert np.all(meta[0].reshape(nb, 128)[:, 3] == 0)

    # the persisted table, then bodies moved: a fired bucket recomputes,
    # a passed-through one keeps its block (zero meta) and its λ
    rng = np.random.default_rng(8)
    moved = geom.copy()
    shift = rng.uniform(-0.05, 0.05, (3, n)).astype(np.float32)
    moved[0:3, :n] += shift
    moved[24:27, :n] += shift
    moved = bf16_pair_exact(moved)
    prev = (np.asarray(jct.table_keys(table)),
            bf16_pair_exact(rng.uniform(0.0, 1.0, (3, cp))))
    for gate in ([1, 0], [0, 1]):
        out, meta, warm = both(moved, gate, table, prev)
        b = gate.index(0)
        cols = slice(b * ccap, (b + 1) * ccap)
        assert np.array_equal(out[:, cols], table[:, cols])
        assert not meta[:, b * 128:(b + 1) * 128].any()
        live = table[tct.CT_ACT, cols] > 0
        assert np.array_equal(warm[0:3, cols][:, live],
                              prev[1][:, cols][:, live])
        f = 1 - b
        fcols = slice(f * ccap, (f + 1) * ccap)
        assert not np.array_equal(out[0:3, fcols], table[0:3, fcols])
