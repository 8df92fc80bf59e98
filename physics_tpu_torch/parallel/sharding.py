"""Row-sharded stepping over torch.distributed (physics_tpu/parallel/
sharding.py `row_sharded_step`).

One scene on several ranks: every rank holds the whole body state and
steps it; the contact work is split by rank. On the contact-table paths
each rank builds the table of its own bucket range and the ranks
all-gather the table; on the generic banded path each rank computes the
ground corners and pair manifolds of its slice of the contact slots and
the ranks all-gather the contacts. The prologue of the solve (sort,
constants) then runs on every rank, the solve's sweeps split the contact
tiles by rank, and one all-reduce of the velocity-table delta follows each
sweep (solver/banded_solve.banded_sweeps_sharded). Only those deltas and
the gathered rows cross ranks, and everything else a rank computes is
deterministic, so every rank ends the step with the same bits.

The collectives (parallel/collectives.py) take the caller's process
group: NCCL with a card for each rank, or gloo, which also runs several
ranks on one card. `launch` spawns the ranks of one host. The JAX
package's env-sharded and hybrid steps need batched environments, which
are not ported (ROADMAP item 1.14, then 1.15); a jointed state is
refused under a shard, because the joints' row-sharded CG is not ported
either (ROADMAP item 1.15; engine.step_with_metrics raises).
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from physics_tpu_torch.engine import step_with_metrics
from physics_tpu_torch.parallel.collectives import shard_of
from physics_tpu_torch.solver.banded_solve import metrics_off


def row_sharded_step(cfg, group=None) -> Callable:
    """A step of one scene split over the ranks of `group` (initialised by
    the caller; None is the default group): bodies replicated, contact
    work and solve tiles split by rank. Returns state → state for the
    calling rank's copy of the state, which every rank passes identical;
    engine.step_with_metrics(state, cfg, shard=shard_of(group)) is the
    same step with its metrics, which this one does not compute.

    The step runs on the state's device and never moves it: under NCCL
    the state must lie on this rank's card. The table paths need
    nb % ranks == 0 (scenes above 128·ranks bodies, padded up) and run
    the unfused solve with the split-impulse pose update: fuse_prep,
    fuse_integrate and contact_rebuild > 1 have no effect."""
    shard = shard_of(group)

    def stepped(state):
        with metrics_off():
            return step_with_metrics(state, cfg, shard=shard)[0]

    return stepped


def _rank_main(rank: int, world: int, backend: str, rendezvous: str,
               fn: Callable, args: Sequence) -> None:
    # the ranks of one host talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        out = fn(shard_of(), *args)
        torch.save(out, f"{rendezvous}.out{rank}")
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Sequence = (),
           backend: str = "gloo") -> list:
    """Run fn(shard, *args) on `world` ranks of this host: spawned
    processes that meet through a file in a temporary directory (no
    network). With NCCL rank r takes card r. `fn` must be importable by
    name (a module-level function). Returns each rank's return value, in
    rank order; an exception in any rank raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_main, args=(world, backend, rendezvous, fn, args),
                 nprocs=world, join=True)
        return [torch.load(f"{rendezvous}.out{r}", weights_only=False)
                for r in range(world)]
