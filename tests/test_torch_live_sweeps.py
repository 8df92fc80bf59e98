"""The banded solves' schedule over the live contacts: sweep 0 visits
every slot (constants, degrees, warm start), the later sweeps only the
contacts whose relaxation or impulse is not zero (`live_slots`), as the
persistent kernels of csrc/banded_solve.cu do. A plain model of that
schedule (`fused_live`, `unfused_live`, built here from the plain
versions' pieces) against the plain versions' full loop over every slot
(banded_sweeps_fused_plain, banded_sweeps_plain), bit for bit in z, λ
and posq, for the fused solve (2.3) on a pile's and a packed envs' table
(anchored contacts whose refreshed depth is ≤ 0, so they scatter their
degree and are not live; inactive slots) and for the unfused sweeps
(2.5), warm start on and off; and the same fused inputs through the JAX package's
Pallas solve in interpret mode.

Tolerance against JAX: 1e-4 of each row's largest magnitude, as
tests/test_torch_banded_solve.py (the JAX kernel reads z through a hi/lo
bf16 split on each of up to 9 sweeps, and the two sum impulses in
different orders). The two schedules sum the same nonzero terms in the
same order (the skipped contacts add exact zeros), so they are compared
with torch.equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig as JaxConfig
from physics_tpu.ops import contact_table as jct
from physics_tpu.solver import contacts_pallas as jcp
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.ops.contact_table import CT_ACT, unified_geom
from physics_tpu_torch.solver import banded_solve as tbs

from tests.test_torch_banded_solve import _inputs, rebuild  # noqa: F401
from tests.test_torch_banded_sweeps import table_inputs  # noqa: F401
from tests.test_torch_config_scene import bf16_pair_exact, configs

N = 192
E, K = 32, 8
SOLVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def packed():
    """(cfg, table, warm8, geom) of the packed envs' anchored refresh: 32
    envs of 8 boxes (two buckets of 768 slots) stepped 30 times along the
    plain path (landed), its persisted table and impulses, and the geometry of the
    state with every body lifted by up to 2 cm, so some anchored contacts
    separate."""
    cfg = tscenes.packed_env_config(E, K)
    st = prepare_contacts(tscenes.packed_envs(E, K, device="cpu"), cfg)
    for _ in range(30):
        st, _ = step_with_metrics(st, cfg)
    rng = np.random.default_rng(11)
    lift = torch.from_numpy(
        rng.uniform(0.0, 0.02, (st.num_bodies, 1)).astype(np.float32))
    moved = st.replace(pos=st.pos + lift * torch.tensor([0.0, 1.0, 0.0]))
    geom = unified_geom(moved, cfg, moved.contact_order)
    cp = st.contact_table.shape[1]
    warm8 = torch.cat([st.contact_lam, torch.zeros((5, cp))])
    return (cfg, torch.from_numpy(bf16_pair_exact(st.contact_table)),
            torch.from_numpy(bf16_pair_exact(warm8)),
            torch.from_numpy(bf16_pair_exact(geom)))


def live_slots(cs, lam):
    """The contacts that later sweeps can change, after sweep 0 left them
    with impulses `lam`: a relaxation R_RELAX ≠ 0 (relaxation · actf_t,
    the refreshed activity on anchored paths) or an impulse ≠ 0. Every
    other contact keeps its λ and adds exact zeros to z in every later
    sweep (csrc/banded_solve.cu solve_kernel's rule)."""
    return ((cs[tbs._R_RELAX] != 0) | (lam[0] != 0) | (lam[1] != 0)
            | (lam[2] != 0))


def live_loop(z, cs, rank_a, rank_b, *, n_sweeps, vel_iters, pos_iters,
              warm):
    """banded_solve._sweep_loop on the kernels' schedule: sweep 0 over
    every contact, the later sweeps over `live_slots` only."""
    lam = [torch.zeros_like(cs[0])] * 4
    idx = None
    for s in range(n_sweeps):
        i = s - 1
        if s == 1:
            idx = torch.nonzero(live_slots(cs, lam)).flatten()
            full, lam = lam, [x[idx] for x in lam]
            cs = [c[idx] for c in cs]
            rank_a, rank_b = rank_a[idx], rank_b[idx]
        lam = tbs._sweep_once(
            z.clone(), z, cs, rank_a, rank_b, lam,
            vel_on=1.0 if 0 <= i < vel_iters else 0.0,
            pos_on=1.0 if 0 <= i < pos_iters else 0.0,
            warm_f=(1.0 if s == 0 else 0.0) if warm else None,
            degf=1.0 if s == 0 else 0.0)
    if idx is not None:
        lam = [f.index_copy(0, idx, x) for f, x in zip(full, lam)]
    return lam


def fused_live(table, warm8, geom, *, vel_iters, pos_iters, use_split,
               anchored, integrate, baum_over_dt, slop, relaxation):
    """banded_sweeps_fused_plain on the live schedule."""
    cs, rank_a, rank_b, d_t, actf_t = tbs.fused_consts_plain(
        table, warm8, geom, use_split=use_split, anchored=anchored,
        baum_over_dt=baum_over_dt, slop=slop, relaxation=relaxation)
    z = torch.zeros((tbs.Z_ROWS, geom.shape[1]), dtype=torch.float32)
    z[0:6] = geom[13:19]
    lam = live_loop(z, cs, rank_a, rank_b,
                    n_sweeps=max(vel_iters, pos_iters) + 1,
                    vel_iters=vel_iters, pos_iters=pos_iters, warm=use_split)
    if anchored:
        lam[3] = d_t * actf_t
    pq = tbs._integrate_plain(z, geom[0:3], geom[19:23], *integrate)
    return z, torch.stack(lam), pq


def unfused_live(z0, bases, la, lb, consts, *, tile, vel_iters, pos_iters,
                 warm_sweep, posq, integrate):
    """banded_sweeps_plain on the live schedule."""
    z = z0.clone()
    lam = live_loop(z, consts, tbs._win_rank(bases, la, tile),
                    tbs._win_rank(bases, lb, tile),
                    n_sweeps=max(vel_iters, pos_iters) + 1,
                    vel_iters=vel_iters, pos_iters=pos_iters,
                    warm=warm_sweep)
    pq = tbs._integrate_plain(z, posq[0:3], posq[3:7], *integrate)
    return z, torch.stack(lam), pq


def _pile(rebuild, schedule):  # noqa: F811
    table, warm8, geom = _inputs(rebuild, schedule)
    return (configs(N)[1], torch.from_numpy(table), torch.from_numpy(warm8),
            torch.from_numpy(geom))


def _fused_kw(cfg, iters, warm):
    return dict(vel_iters=iters, pos_iters=iters if warm else 0,
                use_split=warm, anchored=cfg.contact_rebuild > 1,
                integrate=(cfg.dt, True), baum_over_dt=cfg.baumgarte / cfg.dt,
                slop=cfg.penetration_slop, relaxation=cfg.contact_relaxation)


def _assert_equal(got, ref):
    for name, a, b in zip(("z", "lam", "posq"), got, ref):
        assert torch.equal(a, b), name


CASES = [("pile", "rebuild", 8), ("pile", "refresh", 4),
         ("packed", "refresh", 4)]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("scene,schedule,iters", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_fused_live_schedule_is_the_full_loop(rebuild, packed, scene,  # noqa: F811
                                              schedule, iters, warm):
    cfg, table, warm8, geom = (_pile(rebuild, schedule) if scene == "pile"
                               else packed)
    kw = _fused_kw(cfg, iters, warm)
    live = fused_live(table, warm8, geom, **kw)
    full = tbs.banded_sweeps_fused_plain(table, warm8, geom, **kw)
    _assert_equal(live, full)
    # inactive slots, and on the moved states anchored contacts that
    # separated: active in the table (they scatter their degree) and not
    # live (row 3 of λ is the refreshed depth·activity)
    act = int((table[CT_ACT] > 0).sum())
    n_live = int((live[1][3] > 0).sum())
    assert 0 < act < table.shape[1]
    assert full[0][14].max() >= 3
    if schedule == "refresh":
        assert 0 < n_live < act


@pytest.mark.parametrize("scene,schedule,iters", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_fused_live_schedule_matches_jax(rebuild, packed, scene, schedule,  # noqa: F811
                                         iters):
    cfg, table, warm8, geom = (_pile(rebuild, schedule) if scene == "pile"
                               else packed)
    n = N if scene == "pile" else E * K
    cfg_j = JaxConfig(**dataclasses.asdict(cfg)).replace(z_bf16=False)
    nb, ccap, cp = jct.table_shape(n, cfg_j)
    wtot, _ = jct.geom_pad(n, cfg_j)
    bases = jnp.asarray(np.arange(nb) * 128, jnp.int32)
    run = jax.jit(lambda tb, w, g: jcp.banded_sweeps_fused(
        tb, w, g, bases, cfg_j, tile=ccap, wtot=wtot, vel_iters=iters,
        pos_iters=iters, use_split=True, integrate=(cfg_j.dt, True)))
    jout = [np.asarray(x) for x in run(jnp.asarray(table.numpy()),
                                       jnp.asarray(warm8.numpy()),
                                       jnp.asarray(geom.numpy()))]
    tout = [x.numpy() for x in tbs.banded_sweeps_fused_plain(
        table, warm8, geom, **_fused_kw(cfg, iters, True))]
    assert np.abs(jout[1][0]).sum() > 1
    for name, a, b in zip(("z", "lam", "posq"), jout, tout):
        if name != "lam":
            a, b = a[:, :n], b[:, :n]
        for r in range(a.shape[0]):
            tol = SOLVE_RTOL * max(float(np.abs(a[r]).max()), 1e-3)
            np.testing.assert_allclose(b[r], a[r], rtol=0, atol=tol,
                                       err_msg=f"{name} row {r}")


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_unfused_live_schedule_is_the_full_loop(table_inputs, warm):  # noqa: F811
    """2.5 on the unfused table solve's inputs, with a third of the active
    contacts given zero activity but kept in their window: not live, yet
    their degree is scattered in sweep 0."""
    _, cfg = configs(N)
    geom, bases, la, lb, cin, ccap = table_inputs
    t = torch.from_numpy
    cin = t(cin[warm][:tbs.CIN_ROWS].copy())
    act = np.flatnonzero(la >= 0)
    cin[9, torch.from_numpy(act[::3])] = 0.0
    pk = tbs.prep_kw(cfg, warm)
    consts = tbs.prep_consts_plain(t(geom), t(bases), t(la), t(lb), cin,
                                   tile=ccap, **pk)
    z0 = tbs.banded_z0(t(geom))
    posq = torch.cat([t(geom[0:3]), t(geom[19:23]),
                      torch.zeros((1, geom.shape[1]))])
    kw = dict(tile=ccap, vel_iters=8, pos_iters=8 if warm else 0,
              posq=posq, integrate=(cfg.dt, True))
    args = (z0, t(bases), t(la), t(lb))
    live = unfused_live(*args, consts, warm_sweep=warm, **kw)
    full = tbs.banded_sweeps_plain(*args, t(geom), cin, **kw, **pk)
    _assert_equal(live, full)
    n_live = int(live_slots(consts, [torch.zeros(la.shape[0])] * 3).sum())
    assert n_live == act.size - act[::3].size
    # every active slot's degree, the zero-activity ones too
    deg = torch.zeros(geom.shape[1])
    for loc in (la, lb):
        r = tbs._win_rank(t(bases), t(loc), ccap)
        deg.index_add_(0, r[r >= 0], torch.ones(int((r >= 0).sum())))
    assert torch.equal(full[0][14], deg)
