"""The single-sweep kernel of the row-sharded solve: physics_tpu_torch's
plain `banded_sweep_once` (the CPU side of csrc/banded_solve.cu
bs_banded_sweep_once, kernel 2.7) against the JAX package's Pallas kernel
in interpret mode, one case per switch combination the sharded loop runs:
sweep 0 (degrees and warm start), velocity + position, velocity only,
position only. Then the sharded loop's arithmetic: the deltas of two
halves of the contact tiles summed into z, sweep after sweep, against
banded_sweeps_plain on all of them.

Operands: the unfused table solve of a box_pile(256) (two buckets) that
settled 24 steps on the port, warm-started; the later sweeps read the
velocity table after sweep 0 and one velocity sweep. The port's
constants have 45 rows; the JAX kernel takes 48, zero-padded.

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


@pytest.fixture(scope="module")
def operands():
    """(z0, bases, la, lb, consts, tile) of the settled pile's warm
    unfused table solve, and (z, λ) after sweep 0 and one velocity
    sweep."""
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
    consts = tbs.prep_consts(geom, bases, la, lb, cin, cfg1, tile=ccap,
                             use_split=True)
    z0 = tbs.banded_z0(geom)
    ops = (bases, la, lb, consts)
    dz, lam = tbs.banded_sweep_once(z0, *ops, lam=torch.zeros(
        (4, la.shape[0])), tile=ccap, vel_on=False, pos_on=False, warm=True,
        deg_pass=True)
    z1 = z0 + dz
    dz, lam = tbs.banded_sweep_once(z1, *ops, lam=lam, tile=ccap,
                                    vel_on=True, pos_on=False, warm=False,
                                    deg_pass=False)
    return (z0, *ops, ccap), (z1 + dz, lam)


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_once_matches_jax(operands, case):
    (z0, bases, la, lb, consts, tile), (zm, lam_m) = operands
    vel_on, pos_on, warm, deg_pass = CASES[case]
    if deg_pass:
        z, lam = z0, torch.zeros_like(lam_m)
    else:
        z, lam = zm, lam_m
    z = torch.from_numpy(bf16_pair_exact(z))
    tdz, tlam = tbs.banded_sweep_once(z, bases, la, lb, consts, lam,
                                      tile=tile, vel_on=vel_on,
                                      pos_on=pos_on, warm=warm,
                                      deg_pass=deg_pass)
    cfg_n = tscenes.pile_config(N)
    wtot, _ = jct.geom_pad(N, cfg_n)
    c48 = np.zeros((48, la.shape[0]), np.float32)
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
    if vel_on:
        assert np.abs(jdz[0:6]).max() > 1e-3
    if pos_on:
        assert np.abs(jdz[8:14]).max() > 1e-4
    _rows_close("dz", tdz.numpy(), jdz, RTOL)
    _rows_close("lam", tlam.numpy(), jlam, RTOL)


@pytest.mark.parametrize("vel_iters,pos_iters", [(0, 0), (3, 2)],
                         ids=["one_sweep", "four_sweeps"])
def test_two_halves_sum_to_the_whole(operands, vel_iters, pos_iters):
    (z0, bases, la, lb, consts, tile), _ = operands
    z_ref, lam_ref, _ = tbs.banded_sweeps_plain(
        z0, bases, la, lb, consts, tile=tile, vel_iters=vel_iters,
        pos_iters=pos_iters, warm_sweep=True, posq=None, integrate=None)
    t_half = bases.shape[0] // 2
    c_half = t_half * tile
    halves = [(bases[h * t_half:(h + 1) * t_half],
               la[h * c_half:(h + 1) * c_half],
               lb[h * c_half:(h + 1) * c_half],
               consts[:, h * c_half:(h + 1) * c_half]) for h in (0, 1)]
    lams = [torch.zeros((4, c_half)) for _ in halves]
    z = z0
    for s in range(max(vel_iters, pos_iters) + 1):
        i = s - 1
        dz = torch.zeros_like(z)
        for h, ops in enumerate(halves):
            d, lams[h] = tbs.banded_sweep_once(
                z, *ops, lams[h], tile=tile, vel_on=0 <= i < vel_iters,
                pos_on=0 <= i < pos_iters, warm=s == 0, deg_pass=s == 0)
            dz = dz + d
        z = z + dz
    assert z_ref[14].max() >= 3
    _rows_close("z", z.numpy(), z_ref.numpy(), RTOL)
    _rows_close("lam", torch.cat(lams, dim=1).numpy(), lam_ref.numpy(), RTOL)
