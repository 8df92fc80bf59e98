"""The contact table with saturated buckets: physics_tpu_torch's plain
version (the CPU side of csrc/contact_table.cu) against the JAX package's
Pallas kernel in interpret mode, on the contact-rich two-bucket pile with
every capacity cut below what the buckets hold, so that both drop counters
fire: contacts beyond `bucket_ccap` = 128 slots (meta column 0) and lanes
beyond the cap of the prefilter (`bucket_cap2` = 128, with candidates) or
of the in-kernel broad phase (`bucket_cap` = 128, with bp_k = 16; its
window edge also overflows, meta column 3). Both modes warm-start from the
keys of a first table, a third of them dropped.

Tolerances as tests/test_torch_contact_table.py: geometry and warm
impulses rounded to 16 significant bits (the JAX kernel's hi/lo bf16
split carries them exactly); keys, activity, ranks, meta and warm rows
identical; f32 rows within 4·2⁻¹⁷ × the scene extent.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.state import state_from_arrays

from tests.test_torch_config_scene import (
    bf16_pair_exact,
    configs,
    dense_pile,
    jax_arrays,
)
from tests.test_torch_table_modes import compare

N = 192
CUTS = {
    "candidates": dict(max_contacts_per_pair=2, bucket_ccap=128,
                       bucket_cap2=128),
    "bp_k": dict(max_contacts_per_pair=2, bucket_ccap=128, bucket_cap=128,
                 sweep_window=16),
}


@pytest.mark.parametrize("mode", list(CUTS))
def test_saturated_buckets_drop_as_the_jax_kernel(mode):
    cfg_j, cfg_t = configs(N)
    cfg_j, cfg_t = cfg_j.replace(**CUTS[mode]), cfg_t.replace(**CUTS[mode])
    s = dense_pile(N)
    order = jbp.sweep_order(s, jbp.body_aabbs(s))
    geom = bf16_pair_exact(jct.unified_geom(s, cfg_j, order))
    nb, ccap, cp = jct.table_shape(N, cfg_j)
    jcand = jbp.pair_candidates(s, cfg_j) if mode == "candidates" else None
    tcand = None if jcand is None else PairCandidates(
        *[torch.from_numpy(np.array(x)) for x in jcand])
    run = jax.jit(lambda pk, pl: jct.bucket_contact_table(
        s, jcand, cfg_j, order, prev=(pk, pl), geom=jnp.asarray(geom)))
    t0, _, _ = run(jnp.zeros((2, cp), jnp.int32),
                   jnp.zeros((3, cp), jnp.float32))
    rng = np.random.default_rng(9)
    keys = np.asarray(jct.table_keys(t0))
    keys = keys * (rng.random(cp) > 0.33)[None, :].astype(np.int32)
    lam = bf16_pair_exact(rng.uniform(0.0, 1.0, (3, cp)))
    jout = [np.asarray(x) for x in run(jnp.asarray(keys), jnp.asarray(lam))]

    ts = state_from_arrays(jax_arrays(s), "cpu")
    tout = tct.bucket_contact_table(
        ts, tcand, cfg_t,
        prev=(torch.from_numpy(keys), torch.from_numpy(lam)),
        geom=torch.from_numpy(geom))
    meta = jout[1][0].reshape(nb, 128)
    assert ccap == 128
    assert meta[:, 0].sum() > 0                   # contacts beyond ccap
    assert meta[:, 2].sum() > 0                   # lanes beyond the cap
    assert np.all(jout[0][tct.CT_ACT].reshape(nb, ccap).sum(axis=1)
                  == np.minimum(meta[:, 1], ccap))
    if mode == "bp_k":
        assert meta[:, 3].sum() > 0               # window-edge ranks
    assert np.count_nonzero(jout[2][0]) > 50      # warm-started slots
    compare(jout, tout, float(np.abs(geom[0:3, :N]).max()))
