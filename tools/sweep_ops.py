"""Device operations and device µs of the broad phase's candidates call
and of one sweep of the row-sharded solve, for a checkout of this repo
(its own physics_tpu_torch), on one NVIDIA card.

    python3 tools/sweep_ops.py [CHECKOUT]     # default: this checkout

For each of the 4k pile (table path), the 1,024-hull rain and the
two-kernel 4k pile, settled 20 steps: `pair_candidates` from a given sort
order, profiled over 10 calls (torch.profiler: every kernel, copy and
memset it puts on the card). Then a later sweep of the sharded solve on
rank 0's quarter of the 4k pile's unfused table solve, without the
collective (`banded_sweep_once` on the rank's scratch), what a solve's
constants cost on that rank (its sweep 0, which builds them), and the
two-kernel pile's unfused solve (2.5 with 2.6 in its sweep 0). A
CHECKOUT must have the folded 2.6 (`banded_solve.prep_kw`). One JSON
line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from physics_tpu_torch import scenes
    from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
    from physics_tpu_torch.ops.broadphase import (
        body_aabbs,
        pair_candidates,
        sweep_order,
    )
    from physics_tpu_torch.ops.contact_table import table_shape
    from physics_tpu_torch.solver import banded_solve as bs
    from physics_tpu_torch.solver.contacts import _rebuild

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def measure(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key[:50], e.count / reps, e.self_device_time_total / reps)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        return {"device_ops": sum(r[1] for r in rows),
                "device_us": sum(r[2] for r in rows),
                "by_op": {r[0]: [r[1], round(r[2], 2)] for r in rows}}

    def emit(what, **kw):
        print(json.dumps({"checkout": str(root), "what": what, "card": card,
                          **kw}), flush=True)

    pile_cfg = scenes.pile_config(4096).replace(contact_iters=8)
    paths = {
        "pile": (lambda: scenes.box_pile(4096, x_aspect=16.0, device=dev),
                 pile_cfg),
        "rain": (lambda: scenes.mesh_rain(1024, real_assets=False,
                                          device=dev),
                 scenes.rain_config(1024)),
        "two-kernel pile": (
            lambda: scenes.box_pile(4096, x_aspect=16.0, device=dev),
            pile_cfg.replace(contact_table=False)),
    }
    settled = {}
    for label, (make, cfg) in paths.items():
        st = prepare_contacts(make(), cfg)
        for _ in range(20):
            st, _ = step_with_metrics(st, cfg)
        settled[label] = st
        aabbs = body_aabbs(st)
        order = sweep_order(st, aabbs)
        emit(f"pair_candidates ({label})", **measure(
            lambda st=st, cfg=cfg, aabbs=aabbs, order=order:
            pair_candidates(st, cfg, aabbs, order)))

    # a later sharded sweep on rank 0's quarter of the pile's table solve
    st = settled["pile"]
    ucfg = pile_cfg.replace(contact_rebuild=1, fuse_prep=False,
                            fuse_integrate=False)
    table, _, geom, warm, _ = _rebuild(st, ucfg, True, plain=False)
    bases, la, lb, cin = bs.table_solve_operands(table, warm, 4096, ucfg)
    ccap = table_shape(4096, ucfg)[1]
    z0 = bs.banded_z0(geom)
    t_loc = bases.shape[0] // 4
    c_loc = t_loc * ccap
    pk = bs.prep_kw(ucfg, True)
    ops = (bases[:t_loc], la[:c_loc], lb[:c_loc], geom, cin[:, :c_loc])

    def sweep0():
        sc = bs.sweep_scratch(c_loc, z0.shape[1], dev)
        bs.banded_sweep_once(sc, z0, *ops, sweep=0, tile=ccap, vel_on=False,
                             pos_on=False, **pk)
        return sc
    sc = sweep0()
    bs.banded_sweep_once(sc, z0, *ops, sweep=1, tile=ccap, vel_on=True,
                         pos_on=False, **pk)
    pk = dict(pk, use_split=False)

    def sweep():
        bs.banded_sweep_once(sc, z0, *ops, sweep=2, tile=ccap, vel_on=True,
                             pos_on=True, **pk)
    emit("sharded sweep, rank 0 of 4 (pile), without the collective",
         **measure(sweep))
    emit("sharded solve's constants and sweep 0, rank 0 of 4 (pile)",
         **measure(sweep0))
    two_kernel(settled["two-kernel pile"], paths["two-kernel pile"][1], bs,
               measure, emit)
    return 0


def two_kernel(st, cfg, bs, measure, emit) -> None:
    """The two-kernel pile's unfused solve on its settled state: 2.5 with
    2.6 in its sweep 0."""
    from physics_tpu_torch.solver.contacts import banded_contact_list

    contacts, ranks, _, geom, _, cp, _ = banded_contact_list(st, cfg)
    ops = bs.banded_operands(st, contacts, cfg,
                             (st.contact_key, st.contact_lam), ranks, cp)
    z0 = bs.banded_z0(geom)
    kw = dict(tile=ops.tile, vel_iters=cfg.contact_iters,
              pos_iters=cfg.position_iters if ops.use_split else 0)

    def solve():
        return bs.banded_sweeps(z0, ops.bases, ops.la, ops.lb, geom, ops.cin,
                                **kw, **bs.prep_kw(cfg, ops.use_split))
    emit("two-kernel pile's unfused solve (2.6 + 2.5)", **measure(solve))


if __name__ == "__main__":
    sys.exit(main())
