"""The roofline arithmetic on hand-worked shapes, and the trace's
reduction to busy time and idle gaps on hand-made events."""

from types import SimpleNamespace

import pytest
import torch

from portbench.core import trace, yardstick
from portbench.reference.state import Config


def test_bound_takes_the_larger_and_names_it():
    # 3.35e9 bytes take 1 ms; 67e9 operations take 1 ms
    assert yardstick.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert yardstick.bound(0, 67e9) == (pytest.approx(1.0), "operations")
    assert yardstick.bound(3.35e9, 2 * 67e9)[1] == "operations"


def test_sweep_bound_by_hand():
    # 256 bodies, window 48, buckets of 128 ranks with cap 8·256/2 = 1024
    # lanes (cut to 128·48 = 6144: no cut): order, AABBs and types 32 B a
    # body; five lane fields 17 B a lane; the overflow 4 B. 8 compares a
    # (rank, offset): 8·256·48 operations.
    cfg = Config(sweep_window=48, bucket_block=128, bucket_cap=0,
                 max_pair_candidates=2048, broadphase="sweep")
    st = SimpleNamespace(num_bodies=256)
    nbytes = 32 * 256 + 2 * 1024 * 17 + 4
    assert yardstick.sweep_bound(st, cfg, {}) == yardstick.bound(
        nbytes, 8 * 256 * 48)
    assert yardstick.sweep_bound(st, cfg, {})[1] == "bytes"


def test_solve_bound_by_hand():
    # 2 bodies, one active anchored contact (live), 5 sweeps, 128 slots
    n, cp, npad = 2, 128, 512
    table = torch.zeros((32, cp))
    table[9, 0] = 1.0                   # CT_ACT
    table[13, 0] = 0.0                  # rank a
    table[14, 0] = 2.0                  # rank b + 1
    table[22:25, 0] = torch.tensor([0.0, 1.0, 0.0])   # normal in A
    table[6, 0] = 0.01                  # depth
    geom = torch.zeros((48, npad))
    geom[19, :n] = 1.0                  # identity quats
    geom[12, :n] = 1.0                  # inv mass
    warm = torch.zeros((8, cp))
    warm[0, 0] = 0.5                    # a warm impulse: live
    cfg = Config(contact_rebuild=4, baumgarte=0.2, dt=1 / 60,
                 penetration_slop=0.005, contact_relaxation=1.0)
    st = SimpleNamespace(num_bodies=n)
    got = yardstick.solve_bound(st, cfg, {"table": table, "geom": geom,
                                          "warm": warm, "sweeps": 5})
    ops = 1 * (400 + 250) + 1 * 250 * 4 + 2 * 60
    nbytes = 4 * cp + 4 * 28 * 1 + 4 * 24 * 2 + 4 * (16 * npad + 4 * cp
                                                     + 8 * npad)
    assert got == yardstick.bound(nbytes, ops)


def test_kernel_names():
    names = {
        "void (anonymous namespace)::sweep_kernel<true>(Params)": "2.1 sweep",
        "(anonymous namespace)::box_table_pairs_kernel(float const*)":
            "2.2 contact table",
        "void warm_match_kernel<(anonymous namespace)::box_table_warm>()":
            "2.2 contact table",
        "void (anonymous namespace)::solve_kernel<true>(Params, Live)":
            "2.3 solve",
    }
    for name, group in names.items():
        hits = [g for g, pat in yardstick.GROUPS.items() if pat.search(name)]
        assert hits == [group], name
        assert yardstick.PORT.search(name)
    glue = "void at::native::vectorized_elementwise_kernel<4, add>(int)"
    assert not yardstick.PORT.search(glue)
    assert not yardstick.GROUPS["2.1 sweep"].search(
        "void sharded_sweep_kernel(Params)")


def test_trace_reduction_by_hand():
    dev = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k3", 50.0, 60.0),
           ("k1", 60.0, 65.0)]
    host = [("cudaGraphLaunch", 31.0, 45.0), ("aten::cat", 46.0, 49.0),
            ("outer", 0.0, 100.0)]
    r = trace.reduce(dev, host, (0.0, 100.0))
    assert r.busy_us == pytest.approx(20.0 + 15.0)
    assert r.window_us == 100.0
    ops = dict(r.breakdown["device_ops"])
    assert ops["k1"] == pytest.approx(15e-6)
    gaps = dict(r.breakdown["idle_gaps"])
    # gaps: 0-10 (outer), 30-50 (mid 40: cudaGraphLaunch), 65-100 (outer)
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)
    assert gaps["outer"] == pytest.approx(45e-6)
