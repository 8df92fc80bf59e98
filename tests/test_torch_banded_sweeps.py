"""The unfused banded solve: physics_tpu_torch's plain versions (the CPU
side of csrc/banded_solve.cu bs_banded_sweeps, which builds 2.6's
constants in 2.5's sweep 0) against the JAX package's Pallas kernels in
interpret mode: `prep_consts_plain` against `prep_consts` (kernel 2.6),
and `banded_sweeps` from the contact rows against the JAX
`prep_consts` then `banded_sweeps` (kernel 2.5), cold and warm, with and
without the integration epilogue, on the unfused table solve's inputs (a
contact-rich two-bucket pile, static bases); and `solve_impulses_banded`
in the
`ranks=`/`capacity=` form of the generic path (rank sort, compaction,
dynamic bases, warm match by key), on the two-kernel pile's contacts.

Tolerances. The geometry is rounded to 16 significant bits, which the JAX
kernels' hi/lo bf16 split carries exactly, so 2.6 differs only by f32
operation order: 1e-5 of each constant row's largest magnitude. The sweep
kernel reads the velocity table through that split on each of up to 9
sweeps (about 2⁻¹⁷ relative per read) and both sides sum the impulse
deltas in different orders: 1e-4 of each output row's largest magnitude,
as for the fused solve (tests/test_torch_banded_solve.py).
`solve_impulses_banded` derives its own geometry from the state, so its
split reads of raw values add 2⁻¹⁷ of each value to every constant as
well: 2e-4 (measured 1.2e-4 on one pseudo velocity); its sorted
contacts, keys, counts and overflow counters must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu.ops import narrowphase as jnp_
from physics_tpu.solver import contacts_pallas as jcp
from physics_tpu_torch.ops.contact_table import unified_geom
from physics_tpu_torch.ops.narrowphase import Contacts
from physics_tpu_torch.solver import banded_solve as tbs
from physics_tpu_torch.state import state_from_arrays

from tests.test_torch_config_scene import (
    bf16_pair_exact,
    configs,
    dense_pile,
    jax_arrays,
)
from tests.test_torch_pair_manifolds import np_configs

N = 192
PREP_RTOL = 1e-5
SOLVE_RTOL = 1e-4
RAW_RTOL = 2e-4


def _rows_close(name, got, ref, rtol):
    for r in range(ref.shape[0]):
        tol = rtol * max(float(np.abs(ref[r]).max()), 1e-3)
        np.testing.assert_allclose(got[r], ref[r], rtol=0, atol=tol,
                                   err_msg=f"{name} row {r}")


@pytest.fixture(scope="module")
def table_inputs():
    """(geom, bases, la, lb, cin {cold, warm}) of the unfused table solve
    on a rebuild of the dense pile, as numpy arrays."""
    cfg_j, _ = configs(N)
    cfg_j = cfg_j.replace(contact_rebuild=1, fuse_prep=False)
    s = dense_pile(N)
    order = jbp.sweep_order(s, jbp.body_aabbs(s))
    cand = jbp.pair_candidates(s, cfg_j)
    geom = bf16_pair_exact(jct.unified_geom(s, cfg_j, order))
    table = np.array(jax.jit(lambda c, g: jct.bucket_contact_table(
        s, c, cfg_j, order, geom=g)[0])(cand, jnp.asarray(geom)))
    nb, ccap, cp = jct.table_shape(N, cfg_j)
    base = np.repeat(np.arange(nb) * 128, ccap)
    act = table[jct.CT_ACT] > 0
    has_b = act & (table[jct.CT_RB1] > 0)
    la = np.where(act, table[jct.CT_RA].astype(np.int32) - base, -1)
    lb = np.where(has_b, table[jct.CT_RB1].astype(np.int32) - 1 - base, -1)
    rng = np.random.default_rng(6)
    lam0 = np.zeros((3, cp), np.float32)
    lam0[0] = rng.uniform(0.0, 0.3, cp) * act
    lam0[1:3] = rng.uniform(-0.05, 0.05, (2, cp)) * act
    cin = {}
    for warm in (False, True):
        cin[warm] = np.concatenate([
            table[0:10], lam0 * warm, has_b[None].astype(np.float32),
            np.zeros((2, cp), np.float32)]).astype(np.float32)
    return (geom, (np.arange(nb) * 128).astype(np.int32),
            la.astype(np.int32), lb.astype(np.int32), cin, ccap)


def _jax_prep(inp, warm):
    cfg_j, _ = configs(N)
    geom, bases, la, lb, cin, ccap = inp
    wtot, _ = jct.geom_pad(N, cfg_j)
    return np.array(jax.jit(lambda *a: jcp.prep_consts(
        *a, cfg_j, tile=ccap, wtot=wtot, use_split=warm))(
            jnp.asarray(geom), jnp.asarray(bases), jnp.asarray(la),
            jnp.asarray(lb), jnp.asarray(cin[warm])))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_prep_consts_matches(table_inputs, warm):
    _, cfg_t = configs(N)
    geom, bases, la, lb, cin, ccap = table_inputs
    jc = _jax_prep(table_inputs, warm)
    tc = tbs.prep_consts_plain(
        torch.from_numpy(geom), torch.from_numpy(bases),
        torch.from_numpy(la), torch.from_numpy(lb),
        torch.from_numpy(cin[warm][:tbs.CIN_ROWS]), tile=ccap,
        **tbs.prep_kw(cfg_t, warm)).numpy()
    # the port's constants are the TPU kernel's rows 0:45; the rest of
    # those are zero, and its cin rows 14:16 are padding that no kernel
    # reads
    assert tc.shape == (tbs.R_PREP, la.shape[0])
    assert jc.shape == (48, la.shape[0]) and not jc[tbs.R_PREP:].any()
    act = la >= 0
    assert act.sum() > 500
    # inactive contacts' constants are inert (zero masses and relaxation)
    _rows_close("consts", tc[:, act], jc[:tbs.R_PREP, act], PREP_RTOL)


@pytest.mark.parametrize("warm,integrate", [(False, False), (True, False),
                                            (True, True)],
                         ids=["cold", "warm", "warm-integrate"])
def test_banded_sweeps_matches(table_inputs, warm, integrate):
    cfg_j, cfg_t = configs(N)
    geom, bases, la, lb, cin, ccap = table_inputs
    wtot, npad = jct.geom_pad(N, cfg_j)
    consts = _jax_prep(table_inputs, warm)
    z0 = np.zeros((16, npad), np.float32)
    z0[0:6] = geom[13:19]
    posq = np.concatenate([geom[0:3], geom[19:23],
                           np.zeros((1, npad), np.float32)])
    integ = (cfg_j.dt, True) if integrate else None
    pos_iters = 8 if warm else 0
    run = jax.jit(lambda z, c, pq: jcp.banded_sweeps(
        z, jnp.asarray(bases), jnp.asarray(la), jnp.asarray(lb), c,
        tile=ccap, wtot=wtot, vel_iters=8, pos_iters=pos_iters,
        warm_sweep=warm, posq=pq if integrate else None, integrate=integ))
    jz, jl, jp = run(jnp.asarray(z0), jnp.asarray(consts), jnp.asarray(posq))
    t = torch.from_numpy
    tz, tl, tp = tbs.banded_sweeps(
        t(z0), t(bases), t(la), t(lb), t(geom), t(cin[warm][:tbs.CIN_ROWS]),
        tile=ccap, vel_iters=8, pos_iters=pos_iters,
        posq=t(posq) if integrate else None, integrate=integ,
        **tbs.prep_kw(cfg_t, warm))
    jz, jl = np.asarray(jz), np.asarray(jl)
    assert jz[14, :N].max() >= 4 and np.abs(jl[0]).sum() > 10
    _rows_close("z", tz.numpy()[:, :N], jz[:, :N], SOLVE_RTOL)
    _rows_close("lam", tl.numpy(), jl, SOLVE_RTOL)
    if integrate:
        _rows_close("posq", tp.numpy()[:, :N], np.asarray(jp)[:, :N],
                    SOLVE_RTOL)
    else:
        assert tp is None and jp is None


@pytest.mark.parametrize("cp,solve_kw", [
    (1536, {}), (2048, dict(pallas_tile=1024, pallas_window=128)),
    (384, {})],
    ids=["in-band", "band-overflow", "capacity-overflow"])
def test_solve_impulses_banded_matches(cp, solve_kw):
    """Ground corners and banded pair contacts of the two-kernel pile,
    with their broad-phase ranks, through both packages' banded solve at
    a capacity that cuts the padded list, warm-started from keys of the
    same contacts (a third of them dropped). In the second case tiles of
    1,024 contacts span more ranks than a 128-rank window: the contacts
    outside their tile's window are deactivated and counted in
    band_overflow, by both. In the third the capacity is below the active
    contacts: both keep the same lowest-rank ones and count the rest in
    contact_overflow."""
    cfg_j, cfg_t = np_configs(N)
    s = dense_pile(N)
    order = jbp.sweep_order(s, jbp.body_aabbs(s))
    rank = np.zeros(N, np.int32)
    rank[np.asarray(order)] = np.arange(N)
    cand = jbp.pair_candidates(s, cfg_j)
    gc = jnp_._ground_contacts_boxes(s, cfg_j)
    pc = jax.jit(lambda c: jnp_._pair_contacts_boxes_pallas(s, c, cfg_j))(
        cand)
    kg = gc.body_a.shape[0] // N
    kk = pc.body_a.shape[0] // cand.body_a.shape[0]
    contacts = jnp_.concat_contacts(gc, pc)
    lo = np.concatenate([np.tile(rank, kg), np.tile(np.asarray(cand.rank_a),
                                                    kk)])
    rb = np.concatenate([np.full(kg * N, -1, np.int32),
                         np.tile(np.asarray(cand.rank_b), kk)])
    assert cp < lo.shape[0]    # compaction in the sort
    cfg_j, cfg_t = cfg_j.replace(**solve_kw), cfg_t.replace(**solve_kw)
    rng = np.random.default_rng(7)
    keys = np.asarray(contacts.key)
    keys = np.sort(keys * (rng.random(keys.shape[0]) > 0.33))[-cp:]
    lam = rng.uniform(0.0, 0.2, (3, cp)).astype(np.float32)
    warm = (jnp.asarray(keys.astype(np.int32)), jnp.asarray(lam))
    jout = jax.jit(lambda c, w, r: jcp.solve_impulses_banded(
        s, c, cfg_j, order, warm=w, ranks=r, capacity=cp))(
            contacts, warm, (jnp.asarray(lo), jnp.asarray(rb)))

    ts = state_from_arrays(jax_arrays(s), "cpu")
    torder = torch.from_numpy(np.array(order))
    _, _, npad = tbs.solve_shape(N, cp, cfg_t)
    geom = unified_geom(ts, cfg_t, torder, npad=npad)
    tcont = Contacts(*[torch.from_numpy(np.array(getattr(contacts, f)))
                       for f in Contacts._fields])
    tout = tbs.solve_impulses_banded(
        ts, tcont, cfg_t, torder, geom,
        (torch.from_numpy(keys.astype(np.int32)), torch.from_numpy(lam)),
        (torch.from_numpy(lo), torch.from_numpy(rb)), cp)

    jm, tm = jout[5], tout[5]
    assert set(tm) == set(jm)
    for k in ("contact_count", "band_overflow", "contact_overflow"):
        assert int(tm[k]) == int(jm[k]), k
    count, lost = int(jm["contact_count"]), int(jm["contact_overflow"])
    if cp < 500:
        assert count == cp and lost > 100
    else:
        assert count > 500 and lost == 0
    assert (int(jm["band_overflow"]) > 100) == bool(solve_kw)
    for f in ("body_a", "body_b", "active", "key"):
        assert np.array_equal(getattr(tout[6], f).numpy(),
                              np.asarray(getattr(jout[6], f))), f
    for name, t, j in zip(("vel", "omega", "pvel", "pomega", "lam"),
                          tout[:5], jout[:5]):
        j = np.asarray(j)
        t = t.numpy()
        if name != "lam":
            t, j = t.T, j.T
        _rows_close(name, t, j, RAW_RTOL)
    np.testing.assert_allclose(float(tm["max_penetration"]),
                               float(jm["max_penetration"]), rtol=1e-6)
