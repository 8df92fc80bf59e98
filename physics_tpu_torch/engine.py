"""The simulation step (physics_tpu/engine.py): gravity → joints (none on
the ported path) → velocity integration → contacts → position
integration, on tensors that stay on the state's device. PyTorch runs
eagerly, so `rollout` is a Python loop; the step reads nothing back from
the device.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.ops.contact_table import CT2_ROWS
from physics_tpu_torch.ops.forces import apply_gravity
from physics_tpu_torch.ops.integrator import (
    integrate_positions,
    integrate_velocities,
)
from physics_tpu_torch.parallel.collectives import Shard
from physics_tpu_torch.solver.contacts import (
    anchored_path,
    contact_capacity,
    fused_integration,
    hull_table_path,
    resolve_contacts,
    table_path,
)
from physics_tpu_torch.state import SimState


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


def rollout(state: SimState, cfg: SimConfig, num_steps: int,
            sample_every: int = 0):
    """Run `num_steps` steps. With `sample_every` > 0 returns
    (final_state, (pos [S, N, 3], quat [S, N, 4])) sampled every
    `sample_every` steps; otherwise (final_state, None)."""
    if sample_every > 0 and num_steps % sample_every:
        raise ValueError("num_steps must be a multiple of sample_every")
    pos, quat = [], []
    for k in range(num_steps):
        state = step(state, cfg)
        if sample_every > 0 and (k + 1) % sample_every == 0:
            pos.append(state.pos)
            quat.append(state.quat)
    if sample_every > 0:
        return state, (torch.stack(pos), torch.stack(quat))
    return state, None
