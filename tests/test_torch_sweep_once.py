"""The single-sweep kernel of the row-sharded solve: physics_tpu_torch's
plain `banded_sweep_once` (the CPU side of csrc/banded_solve.cu
bs_sharded_sweep, kernel 2.7: body-major snapshot tables, rotating delta
tables, a live list from sweep 0) against the JAX package's Pallas kernel
in interpret mode, one case per switch combination the sharded loop runs:
sweep 0 (degrees and warm start), velocity + position, velocity only,
position only. Then the sharded loop's arithmetic: the deltas of two
halves of the contact tiles summed, sweep after sweep, against
banded_sweeps_plain on all of them; and the live list and the one-rank
loop, warm and cold.

Operands: the unfused table solve of a box_pile(256) (two buckets) that
settled 24 steps on the port, warm-started; the later sweeps read the
velocity table after sweep 0 and one velocity sweep. The port's sweep 0
builds the constants from the contact rows (kernel 2.6 folded in); the
JAX kernel takes them as an input, the port's prep_consts_plain rows (45)
zero-padded to 48.

Tolerances: 1e-5 of each output row's largest magnitude. The JAX kernel
reads z through a hi/lo bf16 split, exact for the values of 16
significant bits that z is rounded to here, and scatters each contact's
deltas through the same split (about 2⁻¹⁷ of each delta); the two sides
also sum the deltas in different orders. The two-halves loop differs
from the whole one only in that order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.ops import contact_table as jct
from physics_tpu.solver import contacts_pallas as jcp
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.solver import banded_solve as tbs
from physics_tpu_torch.solver.contacts import _rebuild

from tests.test_torch_config_scene import bf16_pair_exact

N = 256
SETTLE = 24
RTOL = 1e-5
CASES = {      # (vel_on, pos_on, warm, deg_pass)
    "sweep0": (False, False, True, True),
    "vel_pos": (True, True, False, False),
    "vel": (True, False, False, False),
    "pos": (False, True, False, False),
}


def _rows_close(name, got, ref, rtol):
    for r in range(ref.shape[0]):
        tol = rtol * max(float(np.abs(ref[r]).max()), 1e-3)
        np.testing.assert_allclose(got[r], ref[r], rtol=0, atol=tol,
                                   err_msg=f"{name} row {r}")


def _z_scratch(z, lam, src):
    """A scratch whose next sweep (2) reads exactly z and λ, with the
    live list and constants of scratch `src`."""
    sc = tbs.sweep_scratch(lam.shape[1], z.shape[1], "cpu")
    sc.zt[1] = z[list(tbs.ZROW)].T
    sc.lam.copy_(lam)
    for t in ("live", "count", "ends", "relax", "consts"):
        getattr(sc, t).copy_(getattr(src, t))
    return sc


def _delta(sc, sweep):
    return tbs.rows_of(sc.dz[sweep % 3])


@pytest.fixture(scope="module")
def operands():
    """(z0, bases, la, lb, geom, cin, consts, tile, the constants'
    keywords but use_split) of the settled pile's warm unfused table
    solve (consts: prep_consts_plain's, warm), and the one-rank loop's
    scratch after sweep 0 and one velocity sweep, with the z those sweeps
    end with."""
    torch.manual_seed(0)
    cfg = tscenes.pile_config(N).replace(contact_iters=8)
    s = prepare_contacts(tscenes.box_pile(N, x_aspect=4.0, device="cpu"),
                         cfg)
    for _ in range(SETTLE):
        s, _ = step_with_metrics(s, cfg)
    cfg1 = cfg.replace(contact_rebuild=1, fuse_prep=False,
                       fuse_integrate=False)
    table, _, geom, warm, _ = _rebuild(s, cfg1, True, plain=True)
    bases, la, lb, cin = tbs.table_solve_operands(table, warm, N, cfg1)
    _, ccap, _ = jct.table_shape(N, cfg1)
    kw = tbs.prep_kw(cfg1, True)
    consts = tbs.prep_consts_plain(geom, bases, la, lb, cin, tile=ccap,
                                   **kw)
    del kw["use_split"]
    z0 = tbs.banded_z0(geom)
    ops = (bases, la, lb, geom, cin)
    sc = tbs.sweep_scratch(la.shape[0], z0.shape[1], "cpu")
    for sweep, vel in ((0, False), (1, True)):
        tbs.banded_sweep_once(sc, z0, *ops, sweep=sweep, tile=ccap,
                              vel_on=vel, pos_on=False, use_split=True, **kw)
    return (z0, *ops, consts, ccap, kw), (sc, tbs.sweep_result(sc, 1))


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_once_matches_jax(operands, case):
    """One sweep of the loop's plain form (sweep 0 from z0; a later sweep
    from the snapshot after sweep 0 and one velocity sweep, over the live
    list) against the JAX kernel on the same z and λ."""
    (z0, bases, la, lb, geom, cin, consts, tile, kw), (sc1, zm) = operands
    vel_on, pos_on, warm, deg_pass = CASES[case]
    c = la.shape[0]
    if deg_pass:
        z = torch.from_numpy(bf16_pair_exact(z0))
        lam = torch.zeros((4, c))
        sc, sweep = tbs.sweep_scratch(c, z.shape[1], "cpu"), 0
    else:
        z = torch.from_numpy(bf16_pair_exact(zm))
        lam = sc1.lam.clone()
        sc, sweep = _z_scratch(z, lam, sc1), 2
    tbs.banded_sweep_once(sc, z, bases, la, lb, geom, cin, sweep=sweep,
                          tile=tile, vel_on=vel_on, pos_on=pos_on,
                          use_split=warm, **kw)
    tdz, tlam = _delta(sc, sweep), sc.lam
    cfg_n = tscenes.pile_config(N)
    wtot, _ = jct.geom_pad(N, cfg_n)
    c48 = np.zeros((48, c), np.float32)
    c48[:tbs.R_PREP] = consts.numpy()
    jdz, jlam = jax.jit(lambda *a: jcp.banded_sweep_once(
        *a, tile=tile, wtot=wtot, vel_on=vel_on, pos_on=pos_on, warm=warm,
        deg_pass=deg_pass))(*[jnp.asarray(x) for x in (
            z.numpy(), bases.numpy(), la.numpy(), lb.numpy(), c48,
            lam.numpy())])
    jdz, jlam = np.asarray(jdz), np.asarray(jlam)
    assert int((la >= 0).sum()) > 300
    if deg_pass:
        assert jdz[14].max() >= 3                    # contact degrees
        assert torch.equal(tbs.rows_of(sc.zt[0]), z)
    else:
        assert 300 < int(sc.count[0]) < c            # a live list
    if vel_on:
        assert np.abs(jdz[0:6]).max() > 1e-3
    if pos_on:
        assert np.abs(jdz[8:14]).max() > 1e-4
    _rows_close("dz", tdz.numpy(), jdz, RTOL)
    _rows_close("lam", tlam.numpy(), jlam, RTOL)


def _halves(bases, la, lb, geom, cin, tile):
    t_half = bases.shape[0] // 2
    c_half = t_half * tile
    return [(bases[h * t_half:(h + 1) * t_half],
             la[h * c_half:(h + 1) * c_half],
             lb[h * c_half:(h + 1) * c_half], geom,
             cin[:, h * c_half:(h + 1) * c_half]) for h in (0, 1)]


@pytest.mark.parametrize("vel_iters,pos_iters", [(0, 0), (3, 2)],
                         ids=["one_sweep", "four_sweeps"])
def test_two_halves_sum_to_the_whole(operands, vel_iters, pos_iters):
    """The loop's plain form on two halves of the tiles, their delta
    tables summed after each sweep as the all-reduce sums them, against
    banded_sweeps_plain on all of them."""
    (z0, bases, la, lb, geom, cin, _, tile, kw), _ = operands
    z_ref, lam_ref, _ = tbs.banded_sweeps_plain(
        z0, bases, la, lb, geom, cin, tile=tile, vel_iters=vel_iters,
        pos_iters=pos_iters, use_split=True, posq=None, integrate=None,
        **kw)
    halves = _halves(bases, la, lb, geom, cin, tile)
    scs = [tbs.sweep_scratch(h[1].shape[0], z0.shape[1], "cpu")
           for h in halves]
    n_sweeps = max(vel_iters, pos_iters) + 1
    for s in range(n_sweeps):
        for sc, ops in zip(scs, halves):
            tbs.banded_sweep_once(sc, z0, *ops, sweep=s, tile=tile,
                                  vel_on=0 <= s - 1 < vel_iters,
                                  pos_on=0 <= s - 1 < pos_iters,
                                  use_split=True, **kw)
        total = scs[0].dz[s % 3] + scs[1].dz[s % 3]
        for sc in scs:
            sc.dz[s % 3] = total
    z = tbs.sweep_result(scs[0], n_sweeps - 1)
    assert torch.equal(z, tbs.sweep_result(scs[1], n_sweeps - 1))
    assert z_ref[14].max() >= 3
    _rows_close("z", z.numpy(), z_ref.numpy(), RTOL)
    _rows_close("lam", torch.cat([sc.lam for sc in scs], dim=1).numpy(),
                lam_ref.numpy(), RTOL)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_live_list_and_one_rank_loop(operands, warm):
    """Sweep 0 lists exactly the slots with a relaxation or an impulse;
    the one-rank loop over that list matches banded_sweeps_plain over
    every slot, the tables rotating as on the card."""
    (z0, bases, la, lb, geom, cin, consts, tile, kw), _ = operands
    vel_iters, pos_iters = 4, 3 if warm else 0
    sc = tbs.sweep_scratch(la.shape[0], z0.shape[1], "cpu")
    n_sweeps = max(vel_iters, pos_iters) + 1
    for s in range(n_sweeps):
        tbs.banded_sweep_once(sc, z0, bases, la, lb, geom, cin, sweep=s,
                              tile=tile, vel_on=0 <= s - 1 < vel_iters,
                              pos_on=0 <= s - 1 < pos_iters, use_split=warm,
                              **kw)
    live = consts[tbs._R_RELAX] != 0
    if warm:
        live = live | (consts[tbs._R_LAM0:tbs._R_LAM0 + 3] != 0).any(0)
    n_live = int(sc.count[0])
    assert n_live == int(live.sum()) and 300 < n_live < la.shape[0]
    assert torch.equal(sc.live[:n_live].long(), torch.nonzero(live)[:, 0])
    z_ref, lam_ref, _ = tbs.banded_sweeps_plain(
        z0, bases, la, lb, geom, cin, tile=tile, vel_iters=vel_iters,
        pos_iters=pos_iters, use_split=warm, posq=None, integrate=None,
        **kw)
    _rows_close("z", tbs.sweep_result(sc, n_sweeps - 1).numpy(),
                z_ref.numpy(), RTOL)
    _rows_close("lam", sc.lam.numpy(), lam_ref.numpy(), RTOL)
