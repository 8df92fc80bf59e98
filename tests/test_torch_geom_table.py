"""The geometry table (ops/contact_table.unified_geom) on the CPU.

A CPU tensor runs the plain version (unified_geom_plain) whether or not
`plain=True` is passed, and launches nothing: the same bits either way,
in box mode with a sort order and with the identity order, in hull mode,
at an explicit width (the generic banded path's body_table_width), on
bodies turned by 180° and on static bodies, where a sum of −0 products
in the world inverse inertia reads +0 only because Python's sum starts
from 0 (so the kernel must start its sums from 0 too).
Each caller in solver/contacts.py (the rebuild, the anchored refresh and
the generic branch's banded_inputs) passes the step's `plain` through to
it. The kernel (csrc/geom_table.cu) is held to the plain version bit for
bit on the card (tests/test_torch_cuda.py).
"""

import itertools
import sys

import numpy as np
import pytest
import torch

from physics_tpu_torch import scenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops.broadphase import body_aabbs, sweep_order
from physics_tpu_torch.ops.narrowphase_banded import body_table_width
from physics_tpu_torch.solver import contacts as tc


# the unit quaternions whose components are 0, −0, ±1 or ±√½: turns by
# 90° and 180° about axes and diagonals, some with −0 components
UNIT_TURNS = [q for q in itertools.product(
    (0.0, -0.0, 1.0, -1.0, 0.70710677, -0.70710677), repeat=4)
    if abs(sum(x * x for x in q) - 1.0) < 1e-6]


def flipped(s):
    """s with body i turned by UNIT_TURNS[i mod 160]."""
    q = torch.tensor(UNIT_TURNS, dtype=torch.float32, device=s.device)
    idx = torch.arange(s.num_bodies, device=s.device) % len(UNIT_TURNS)
    return s.replace(quat=q[idx].contiguous())


def statics(s, seed=0):
    """s with every third body static (inverse mass and inertia 0) and
    every body at a random orientation."""
    q = np.random.default_rng(seed).normal(size=(s.num_bodies, 4))
    q = torch.tensor(q / np.linalg.norm(q, axis=1, keepdims=True),
                     dtype=torch.float32, device=s.device)
    still = (torch.arange(s.num_bodies, device=s.device) % 3 == 0)
    return s.replace(
        quat=q,
        inv_mass=torch.where(still, 0.0, s.inv_mass),
        inv_inertia=torch.where(still[:, None, None], 0.0, s.inv_inertia))


def _sorted(s):
    return sweep_order(s, body_aabbs(s))


def _box_order():
    s = scenes.box_pile(256, x_aspect=4.0, device="cpu")
    return s, scenes.pile_config(256), _sorted(s), {}


def _box_identity():
    s = scenes.packed_envs(20, 8, device="cpu")       # 160 bodies
    return s, scenes.packed_env_config(20, 8), None, {}


def _hull():
    s = scenes.mesh_rain_mixed(48, n_types=3, real_assets=False,
                               device="cpu")
    return s, scenes.rain_config(48), _sorted(s), {"hulls": True}


def _npad():
    cfg = scenes.pile_config(192).replace(contact_table=False)
    s = scenes.box_pile(192, x_aspect=4.0, layers=3, device="cpu")
    return s, cfg, _sorted(s), {"npad": body_table_width(192, cfg)}


def _turned(turn):
    def make():
        s = turn(scenes.box_pile(256, x_aspect=4.0, device="cpu"))
        return s, scenes.pile_config(256), _sorted(s), {}
    return make


GEOM_CASES = {"box_order": _box_order, "box_identity": _box_identity,
              "hull": _hull, "npad": _npad, "flipped": _turned(flipped),
              "statics": _turned(statics)}


@pytest.mark.parametrize("case", list(GEOM_CASES))
def test_unified_geom_plain_switch_same_bits(case):
    s, cfg, order, kw = GEOM_CASES[case]()
    n = s.num_bodies
    npad = kw.get("npad", tct.geom_pad(n, cfg)[1])
    n0 = tct.unified_geom.launches
    got = tct.unified_geom(s, cfg, order, **kw)
    ref = tct.unified_geom(s, cfg, order, plain=True, **kw)
    assert tct.unified_geom.launches == n0
    assert got.shape == ref.shape == (48, npad)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    # what the kernel reproduces: the body id of each rank, zero columns
    # from N on
    ids = torch.arange(n) if order is None else order.long()
    assert torch.equal(got[42, :n], ids.to(torch.float32))
    assert not got[:, n:].any()


@pytest.mark.parametrize("case", ["flipped", "statics"])
def test_sandwich_sums_start_from_zero(case):
    """On these bodies the world inverse inertia (rows 3:12) has entries
    whose three products are all −0: summed from 0 they read +0, summed
    from the first product −0. The table holds the former."""
    s, cfg, order, _ = GEOM_CASES[case]()
    r = v3.quat_to_mat(s.quat)
    m = v3.mat_unpack(s.inv_inertia)
    t = [r[3 * i] * m[j] + r[3 * i + 1] * m[3 + j] + r[3 * i + 2] * m[6 + j]
         for i in range(3) for j in range(3)]
    unled = torch.stack([t[3 * i] * r[3 * j] + t[3 * i + 1] * r[3 * j + 1]
                         + t[3 * i + 2] * r[3 * j + 2]
                         for i in range(3) for j in range(3)])
    geom = tct.unified_geom(s, cfg, order)
    iw = geom[3:12, :s.num_bodies]
    unled = unled[:, order.long()]
    assert torch.equal(iw, unled)               # equal as numbers
    minus0 = (unled.view(torch.int32) == -(1 << 31)) & (iw.view(
        torch.int32) == 0)
    assert int(minus0.sum()) > 0


def _table_pile():
    cfg = scenes.pile_config(256)
    return prepare_contacts(scenes.box_pile(256, x_aspect=4.0,
                                            device="cpu"), cfg), cfg


def _refresh_pile():
    s, cfg = _table_pile()
    s, _ = step_with_metrics(s, cfg, plain=True)     # the rebuild, step 0
    return s, cfg


def _two_kernel():
    cfg = scenes.pile_config(192).replace(contact_iters=8,
                                          contact_table=False,
                                          contact_rebuild=1)
    return prepare_contacts(scenes.box_pile(192, x_aspect=4.0, layers=3,
                                            device="cpu"), cfg), cfg


# the function of solver/contacts.py that calls unified_geom on the step
CALLERS = {"_rebuild": _table_pile, "_resolve_contacts_table": _refresh_pile,
           "banded_inputs": _two_kernel}


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("caller", list(CALLERS))
def test_callers_pass_plain_to_unified_geom(caller, plain, monkeypatch):
    s, cfg = CALLERS[caller]()
    seen = []
    real = tc.unified_geom

    def spy(*args, **kw):
        seen.append((sys._getframe(1).f_code.co_name, kw.get("plain")))
        return real(*args, **kw)

    monkeypatch.setattr(tc, "unified_geom", spy)
    n0 = tct.unified_geom.launches
    step_with_metrics(s, cfg, plain=plain)
    assert seen == [(caller, plain)]
    assert tct.unified_geom.launches == n0
