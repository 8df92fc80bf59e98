"""The simulation step (physics_tpu/engine.py): gravity → joints (none on
the ported path) → velocity integration → contacts → position
integration, on tensors that stay on the state's device; the step reads
nothing back from the device. PyTorch runs eagerly: on a CUDA state
`rollout` replays the step from captured CUDA graphs (DeviceStepper), as
the JAX package runs its horizon in lax.scan, and on the CPU it is a
Python loop.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.ops.contact_table import (
    CT2_ROWS,
    bucket_contact_table,
)
from physics_tpu_torch.ops.forces import apply_gravity
from physics_tpu_torch.ops.hull_table import (
    bucket_hull_contact_table,
    scratch_buffers,
)
from physics_tpu_torch.ops.integrator import (
    integrate_positions,
    integrate_velocities,
)
from physics_tpu_torch.ops.narrowphase import banded_contacts
from physics_tpu_torch.ops.sweep_kernel import (
    bucketed_candidates,
    sweep_window_masks,
)
from physics_tpu_torch.parallel.collectives import Shard
from physics_tpu_torch.solver.banded_solve import (
    banded_sweep_once,
    banded_sweeps,
    banded_sweeps_fused,
    folded_prep_consts,
)
from physics_tpu_torch.solver.contacts import (
    anchored_path,
    contact_capacity,
    forced_rebuild,
    fused_integration,
    hull_table_path,
    rebuild_branch,
    resolve_contacts,
    table_path,
)
from physics_tpu_torch.state import SimState

# every kernel wrapper's launch counter (`launches`, a host integer)
COUNTED = (sweep_window_masks, bucketed_candidates, bucket_contact_table,
           bucket_hull_contact_table, banded_contacts, banded_sweeps_fused,
           banded_sweeps, folded_prep_consts, banded_sweep_once)


def step_with_metrics(state: SimState, cfg: SimConfig,
                      plain: bool = False,
                      shard: Shard | None = None) -> Tuple[SimState, Dict]:
    """One simulation step; returns (new_state, metrics) with the metrics
    as device tensors. `plain=True` runs the kernels' plain versions on
    any device (the reference for checking the kernel path on the card).
    `shard` (parallel.collectives.Shard) is the calling rank's place in a
    row-sharded step: every rank passes the same state and gets the same
    new state, and the contact work is split by rank (parallel.sharding.
    row_sharded_step)."""
    if state.joints.capacity > 0:
        raise NotImplementedError("joints are ROADMAP item 1.11")
    dev = state.device
    if shard is not None:
        shard.check_device(dev)
    joint_metrics = {
        "cg_iters": torch.zeros((), dtype=torch.int32, device=dev),
        "cg_converged": torch.ones((), dtype=torch.bool, device=dev),
    }
    state = apply_gravity(state, cfg)
    state = integrate_velocities(state, cfg)
    contact_metrics: Dict = {}
    contacts_on = cfg.ground_plane or cfg.pair_collisions
    if contacts_on:
        state, contact_metrics = resolve_contacts(state, cfg, plain=plain,
                                                  shard=shard)
    if contacts_on and fused_integration(state, cfg, shard):
        # pos/quat were integrated by the solve's epilogue
        state = state.replace(
            force=torch.zeros_like(state.force),
            torque=torch.zeros_like(state.torque),
            step_count=state.step_count + 1,
            step_count_host=state.step_count_host + 1,
        )
    else:
        state = integrate_positions(state, cfg)
    return state, {**joint_metrics, **contact_metrics}


def step(state: SimState, cfg: SimConfig) -> SimState:
    """One simulation step."""
    return step_with_metrics(state, cfg)[0]


def prepare_contacts(state: SimState, cfg: SimConfig) -> SimState:
    """Allocate the warm-start buffers (and, for contact_rebuild > 1 on an
    anchored path, the persisted table, rank order, overflow counters and
    reference poses) that the contact paths carry across steps: [2, c]
    component-form keys on the table paths, [c] packed keys on the
    generic path. contact_order starts as the identity (the packed envs'
    order for good). The JAX package's z_bf16 guard is not needed: the
    port moves z in f32."""
    c = contact_capacity(state, cfg)
    dev = state.device
    n = state.num_bodies
    table = table_path(state, cfg) or hull_table_path(state, cfg)
    extra = {}
    if cfg.contact_rebuild > 1 and not anchored_path(state, cfg):
        warnings.warn(
            "cfg.contact_rebuild > 1 has no effect here (needs an "
            "unsharded contact-table path — box or hull — with fuse_prep, "
            "fed by the bucketed sweep without bp_inkernel or by packed "
            "envs; see solver.contacts.anchored_path) — rebuilding "
            "contacts every step", stacklevel=2)
    elif cfg.contact_rebuild > 1:
        extra = dict(
            contact_table=torch.zeros((CT2_ROWS, c), dtype=torch.float32,
                                      device=dev),
            contact_order=torch.arange(n, dtype=torch.int32, device=dev),
            contact_meta=torch.zeros((2,), dtype=torch.int32, device=dev),
            contact_ref=torch.cat([state.pos, state.quat], dim=1),
        )
    return state.replace(
        contact_key=torch.zeros((2, c) if table else (c,),
                                dtype=torch.int32, device=dev),
        contact_lam=torch.zeros((3, c), dtype=torch.float32, device=dev),
        **extra,
    )


def _copy_into(dst: SimState, src: SimState) -> None:
    """Copy each tensor field of `src` that is not dst's own into dst's
    (in place); the step never replaces a nested table (shapes, hulls,
    joints)."""
    for f in dataclasses.fields(dst):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if isinstance(a, torch.Tensor):
            if b is not a:
                a.copy_(b)
        elif dataclasses.is_dataclass(a) and b is not a:
            raise NotImplementedError(f"rollout: the step replaced {f.name}")


def _own(new: SimState, old: SimState) -> SimState:
    """`new` with a copy of each tensor field that shares memory with a
    field of `old`: buffers that the graphs may write in place, where the
    caller's state must not change."""
    theirs = {getattr(old, f.name).untyped_storage().data_ptr()
              for f in dataclasses.fields(old)
              if isinstance(getattr(old, f.name), torch.Tensor)}
    return new.replace(**{
        f.name: getattr(new, f.name).clone() for f in dataclasses.fields(new)
        if isinstance(getattr(new, f.name), torch.Tensor)
        and getattr(new, f.name).untyped_storage().data_ptr() in theirs})


def capture_graph(fn: Callable[[], None], pool):
    """`fn` captured in a torch.cuda.CUDAGraph on the memory pool `pool`
    (None: a new one). Raises, with the cause, if the capture fails."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            fn()
    except RuntimeError as e:
        raise RuntimeError(f"rollout: capturing a step in a CUDA graph "
                           f"failed ({type(e).__name__}: {e}); the device "
                           f"rollout does not step eagerly instead") from e
    return graph


class DeviceStepper:
    """Steps a state from captured CUDA graphs: what `rollout` runs on a
    CUDA state.

    Each distinct branch of the step is captured once, as a graph over
    static state buffers that ends by copying its new state into them, so
    replays chain and the host does nothing else a step. On an anchored
    path (contact_rebuild K > 1) the branches are the rebuild step and
    the refresh step, picked on the host before each step
    (solver.contacts.rebuild_branch: step_count_host % K, and on a hull
    table path with vel_factor > 0 the motion guard's one device read);
    elsewhere there is one. Before a branch is captured, one real eager
    step of that branch runs: it builds the kernels, fills the caches
    (hull_table_coef, the static window bases, 2.4's scratch) and is a
    step of the horizon. The graphs share one memory pool: each reads
    only the static buffers and what it writes itself, and they never run
    at once. The stepper keeps every cached buffer a graph captured that
    a later call could free (2.4's scratch, which a larger call replaces;
    the window bases are never evicted). The wrappers'
    `launches` counters count real launches: a capture adds nothing, a
    replay adds the launches its graph captured.

    `capture` (capture_graph's signature) is what records a step; the
    tests put an eager stand-in there to check the schedule on the CPU."""

    def __init__(self, state: SimState, cfg: SimConfig,
                 capture: Callable = capture_graph):
        self.cfg = cfg
        self.state = state         # the static buffers after the first step
        self._owned = False
        self._capture = capture
        self._graphs: Dict = {}    # branch → (graph, [(counter, launches)])
        self._pool = None
        self._held: list = []

    @property
    def captured(self) -> set:
        """The branches captured so far (see rebuild_branch)."""
        return set(self._graphs)

    def step(self) -> SimState:
        """One step: the branch's graph replayed, or its warm-up step and
        capture. Returns the static state (valid until the next step)."""
        branch = rebuild_branch(self.state, self.cfg)
        if branch in self._graphs:
            graph, counts = self._graphs[branch]
            graph.replay()
            for counter, n in counts:
                counter.launches += n
            self.state.step_count_host += 1
            return self.state
        with forced_rebuild(branch):
            new = step(self.state, self.cfg)
        if self._owned:
            _copy_into(self.state, new)
            self.state.step_count_host = new.step_count_host
        else:
            self.state = _own(new, self.state)
            self._owned = True
        static, cfg = self.state, self.cfg

        def one_step():
            with forced_rebuild(branch):
                _copy_into(static, step(static, cfg))
        before = [c.launches for c in COUNTED]
        graph = self._capture(one_step, self._pool)
        # a capture launches nothing: its counts move to the replays
        counts = [(c, c.launches - b) for c, b in zip(COUNTED, before)
                  if c.launches != b]
        for c, b in zip(COUNTED, before):
            c.launches = b
        self._graphs[branch] = (graph, counts)
        if self._pool is None:
            self._pool = graph.pool()
        self._held.extend(scratch_buffers())
        return self.state


def rollout(state: SimState, cfg: SimConfig, num_steps: int,
            sample_every: int = 0):
    """Run `num_steps` steps. With `sample_every` > 0 returns
    (final_state, (pos [S, N, 3], quat [S, N, 4])) sampled every
    `sample_every` steps; otherwise (final_state, None).

    On a CUDA state the steps are replays of captured CUDA graphs
    (DeviceStepper; the first step of each branch runs eagerly before its
    capture), with no host↔device sync inside the horizon but the hull
    motion guard's read where vel_factor > 0; the samples are copied on
    the device. A capture that fails raises. On the CPU it is a loop of
    `step`. Both give what the loop gives."""
    if sample_every > 0 and num_steps % sample_every:
        raise ValueError("num_steps must be a multiple of sample_every")
    if state.device.type == "cuda":
        stepper = DeviceStepper(state, cfg)
        advance = stepper.step
    else:
        def advance():
            nonlocal state
            state = step(state, cfg)
            return state
    pos, quat = [], []
    for k in range(num_steps):
        state = advance()
        if sample_every > 0 and (k + 1) % sample_every == 0:
            pos.append(state.pos.clone())
            quat.append(state.quat.clone())
    if sample_every > 0:
        return state, (torch.stack(pos), torch.stack(quat))
    return state, None
