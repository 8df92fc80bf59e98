"""The simulation step (physics_tpu/engine.py): gravity → joints (the
constraint rows and their CG solve, csrc/joint_cg.cu on the card) →
velocity integration → contacts → position integration, on tensors that
stay on the state's device; the step reads nothing back from the device,
except that an eager step on a hull table path with the motion guard
(contact_rebuild_vel_factor > 0) reads the guard's predicate to pick
rebuild or refresh. PyTorch runs eagerly: on a CUDA state `rollout`
replays the step from captured CUDA graphs (DeviceStepper), which decide
that guard on the device as the JAX package's lax.cond does, so the
horizon reads nothing back; on the CPU it is a Python loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings
from typing import Callable, Dict, List, Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import quaternion as quat
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
from physics_tpu_torch.solver import cg
from physics_tpu_torch.solver.banded_solve import (
    banded_sweep_once,
    banded_sweeps,
    banded_sweeps_fused,
    folded_prep_consts,
)
from physics_tpu_torch.solver.contacts import (
    GUARDED,
    anchored_path,
    contact_capacity,
    forced_rebuild,
    fused_integration,
    guard_fires,
    hull_table_path,
    rebuild_branch,
    resolve_contacts,
    table_path,
)
from physics_tpu_torch.solver.joints import (
    apply_w,
    j_matvec,
    jd_matvec,
    joint_rows,
    jt_matvec,
)
from physics_tpu_torch.state import SimState

# every kernel wrapper's launch counter (`launches`, a host integer)
COUNTED = (sweep_window_masks, bucketed_candidates, bucket_contact_table,
           bucket_hull_contact_table, banded_contacts, banded_sweeps_fused,
           banded_sweeps, folded_prep_consts, banded_sweep_once, cg.solve)


def _w_blocks(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """The inverse generalised mass W of each body as [N, 10]: a linear
    scale, then the 3×3 angular block (row-major); joints.apply_w(W, x)
    is physics_tpu/engine.py's `_w_apply(state, cfg, x)`. compat
    (quirk Q3): 1/m on all six DOFs, the angular block diag(1/m) — the
    inverse mass, not the inertia. Otherwise inv_mass and the world-frame
    inverse inertia R·I⁻¹·Rᵀ (statics exactly zero)."""
    if cfg.compat:
        inv_m = 1.0 / state.mass
        z = torch.zeros_like(inv_m)
        return torch.stack([inv_m, inv_m, z, z, z, inv_m, z, z, z, inv_m],
                           dim=1)
    rot = quat.to_matrix(state.quat)
    ri = torch.sum(rot[:, :, :, None] * state.inv_inertia[:, None, :, :],
                   dim=2)
    iw = torch.sum(ri[:, :, None, :] * rot[:, None, :, :], dim=-1)
    return torch.cat([state.inv_mass[:, None], iw.reshape(-1, 9)], dim=1)


def joint_system(state: SimState, cfg: SimConfig):
    """The joint solve's system J·W·Jᵀλ = rhs for `state` (its forces
    accumulated): (rows, W blocks [N, 10], rhs [J·3]), rhs in the
    reference's term order −J̇q̇ − J·(W·F_ext) − ks∘C − kd∘(J·q̇)."""
    rows = joint_rows(state)
    w = _w_blocks(state, cfg)
    q_dot = torch.cat([state.vel, state.omega], dim=-1)
    f_ext = torch.cat([state.force, state.torque], dim=-1)
    jd_qd = -jd_matvec(rows, q_dot)
    c_dot = j_matvec(rows, q_dot)
    ks_c = (rows.ks * rows.c).reshape(-1)
    kd_cdot = rows.kd.reshape(-1) * c_dot
    rhs = jd_qd - j_matvec(rows, apply_w(w, f_ext)) - ks_c - kd_cdot
    return rows, w, rhs


def solve_joints(state: SimState, cfg: SimConfig, plain: bool = False
                 ) -> Tuple[SimState, Dict]:
    """The joint rows, the CG solve of J·W·Jᵀλ = rhs and Jᵀλ applied as
    forces (physics_tpu/engine.py `solve_joints`, unsharded; the system:
    joint_system). Where the CG did not converge, no force is applied and the warm start stays
    the previous step's (quirk Q7); in compat only body 0 receives the
    constraint force (quirk Q1). `plain=True` runs the CG's plain version
    on any device. Returns the metrics cg_iters (int32) and cg_converged
    (bool) as device tensors."""
    dev = state.device
    if state.joints.capacity == 0:
        return state, {
            "cg_iters": torch.zeros((), dtype=torch.int32, device=dev),
            "cg_converged": torch.ones((), dtype=torch.bool, device=dev)}
    n = state.num_bodies
    rows, w, rhs = joint_system(state, cfg)
    lam, converged, iters = cg.solve(
        rows, w, rhs, state.lam_joint, max_iters=cfg.cg_max_iters,
        rel_tol=cfg.cg_rel_tol, abs_tol=cfg.cg_abs_tol, plain=plain)
    lam_warm = torch.where(converged, lam, state.lam_joint)
    gain = converged.to(torch.float32)
    jtl = jt_matvec(rows, lam, n)
    if cfg.compat:
        # Q1: the reference iterates the 6N-vector Jᵀλ as one column, so
        # only entity 0 receives constraint force
        only0 = (torch.arange(n, device=dev) == 0).to(torch.float32)
        jtl = jtl * only0[:, None]
    state = state.replace(force=state.force + gain * jtl[:, :3],
                          torque=state.torque + gain * jtl[:, 3:],
                          lam_joint=lam_warm)
    return state, {"cg_iters": iters, "cg_converged": converged}


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
    dev = state.device
    if shard is not None:
        if state.joints.capacity > 0:
            raise NotImplementedError(
                "the row-sharded joint CG (a jointed state under shard=) is "
                "ROADMAP item 1.15")
        shard.check_device(dev)
    state = apply_gravity(state, cfg)
    state, joint_metrics = solve_joints(state, cfg, plain=plain)
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
    order for good). Without contacts (the jointed scenes) the state's
    empty buffers stay as they are. The JAX package's z_bf16 guard is not
    needed: the port moves z in f32."""
    if not (cfg.ground_plane or cfg.pair_collisions):
        return state
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
    (None: a new one), its raw cudaGraph_t kept (ConditionalGraph embeds
    it). Raises, with the cause, if the capture fails."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(graph, pool=pool):
            fn()
    except RuntimeError as e:
        raise RuntimeError(f"rollout: capturing a step in a CUDA graph "
                           f"failed ({type(e).__name__}: {e}); the device "
                           f"rollout does not step eagerly instead") from e
    return graph


class ConditionalGraph:
    """One replayable graph of three captured ones (capture_graph): `pred`,
    which writes the int32 [1] tensor `flag`, then `on_true` if the flag
    is not 0, else `on_false`, behind two conditional nodes
    (csrc/graph_cond.cu), so the device decides at each replay and
    nothing is read back. Raises if the composition fails."""

    def __init__(self, pred, flag, on_true, on_false):
        from physics_tpu_torch import _build

        self._lib = _build.library()
        # the captured graphs own their memory pool's blocks: keep them
        self._parts = (pred, flag, on_true, on_false)
        out = (ctypes.c_void_p * 2)()
        with torch.cuda.device(flag.device):
            err = self._lib.gc_compose(
                ctypes.c_void_p(pred.raw_cuda_graph()),
                ctypes.c_void_p(flag.data_ptr()),
                ctypes.c_void_p(on_true.raw_cuda_graph()),
                ctypes.c_void_p(on_false.raw_cuda_graph()),
                ctypes.cast(out, ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(
                f"rollout: composing the motion guard's conditional graph "
                f"failed (CUDA error {err}: "
                f"{self._lib.pk_error_string(err).decode()}); the device "
                f"rollout does not read the guard back instead")
        self._exec, self._graph = out[0], out[1]

    def replay(self) -> None:
        from physics_tpu_torch import _build

        dev = self._parts[1].device
        _build.check(self._lib.gc_launch(
            ctypes.c_void_p(self._exec),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
            "gc_launch")

    def __del__(self):
        if getattr(self, "_exec", None):
            self._lib.gc_destroy(ctypes.c_void_p(self._exec),
                                 ctypes.c_void_p(self._graph))


def _counts() -> List[int]:
    return [c.launches for c in COUNTED]


def _launched(after: List[int], before: List[int]) -> list:
    """[(counter, launches)] between two readings of the counters."""
    return [(c, a - b) for c, a, b in zip(COUNTED, after, before) if a != b]


def _restore(counts: List[int]) -> None:
    for c, n in zip(COUNTED, counts):
        c.launches = n


def _add(launched: list, times: int = 1) -> None:
    for c, n in launched:
        c.launches += times * n


def _guard(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """The motion guard's predicate for the step of `state`: on the
    velocities its contacts see (gravity, the joints, the velocity
    integration)."""
    st = apply_gravity(state, cfg)
    st, _ = solve_joints(st, cfg)
    return guard_fires(integrate_velocities(st, cfg), cfg)


def _pick(fire: torch.Tensor, a: SimState, b: SimState) -> SimState:
    """Each tensor field of `a` where `fire`, else of `b`."""
    return a.replace(**{
        f.name: torch.where(fire, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
        if isinstance(getattr(a, f.name), torch.Tensor)
        and getattr(a, f.name) is not getattr(b, f.name)})


class DeviceStepper:
    """Steps a state from captured CUDA graphs: what `rollout` runs on a
    CUDA state.

    Each distinct branch of the step is captured once, as a graph over
    static state buffers that ends by copying its new state into them, so
    replays chain and the host does nothing else a step. On an anchored
    path (contact_rebuild K > 1) the scheduled steps (step_count_host %
    K == 0) are the rebuild branch and the others the refresh branch,
    both picked on the host from its mirror of the step count
    (solver.contacts.rebuild_branch); on a hull table path with
    vel_factor > 0 the others are one GUARDED branch instead, as the JAX
    package's lax.cond: the motion guard's predicate, then the rebuild
    step behind a conditional node on it and the refresh step behind one
    on its negation (ConditionalGraph), so a replay reads nothing back.
    Elsewhere there is one branch (the jointed steps without contacts
    among them). Before a branch is captured, one real eager step of that
    branch runs (the GUARDED one runs both steps and picks by the
    predicate on the device): it builds the kernels, fills the caches
    (hull_table_coef, the static window bases, 2.4's scratch) and is a
    step of the horizon. The graphs share one memory pool: each reads
    only the static buffers and what it writes itself, and they never run
    at once. The stepper keeps every cached buffer a graph captured that
    a later call could free (2.4's scratch, which a larger call replaces;
    the window bases are never evicted). The wrappers' `launches`
    counters count real launches: a capture adds nothing, a replay adds
    the launches its graph captured; the host cannot see which side a
    GUARDED step took, so the rebuild side adds 1 to a device tally and
    settle() (which rollout calls after its last step) reads it once and
    adds each side's launches.

    `capture` (capture_graph's signature) records a step and `compose`
    (ConditionalGraph's) joins the GUARDED graphs; the tests put eager
    stand-ins there to check the schedule on the CPU."""

    def __init__(self, state: SimState, cfg: SimConfig,
                 capture: Callable = capture_graph,
                 compose: Callable = ConditionalGraph):
        self.cfg = cfg
        self.state = state         # the static buffers after the first step
        self._owned = False
        self._capture = capture
        self._compose = compose
        self._graphs: Dict = {}    # branch → (graph, [(counter, launches)])
        self._pool = None
        self._held: list = []
        # GUARDED: the predicate's flag, the rebuilds taken since settle(),
        # the steps decided since, each side's launches
        self._flag = None
        self._tally = None
        self._pending = 0
        self._sides = ([], [])

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
            _add(counts)
            self._pending += branch == GUARDED
            self.state.step_count_host += 1
            return self.state
        if branch == GUARDED:
            new = self._guarded_warm_up()
        else:
            with forced_rebuild(branch):
                new = step(self.state, self.cfg)
        if self._owned:
            _copy_into(self.state, new)
            self.state.step_count_host = new.step_count_host
        else:
            self.state = _own(new, self.state)
            self._owned = True
        static, cfg = self.state, self.cfg

        def one_step(rebuild):
            def run():
                with forced_rebuild(rebuild):
                    _copy_into(static, step(static, cfg))
                if rebuild and branch == GUARDED:
                    self._tally.add_(1)
            return run
        if branch != GUARDED:
            self._graphs[branch] = self._captured(one_step(branch))
            return self.state
        pred, counts = self._captured(
            lambda: self._flag.copy_(_guard(static, cfg)))
        on_true, true_counts = self._captured(one_step(True))
        on_false, false_counts = self._captured(one_step(False))
        self._sides = (true_counts, false_counts)
        self._graphs[GUARDED] = (self._compose(pred, self._flag, on_true,
                                               on_false), counts)
        return self.state

    def _captured(self, fn):
        """(fn's graph, the launches it captured): a capture launches
        nothing, so its counts move to the replays."""
        before = _counts()
        graph = self._capture(fn, self._pool)
        counts = _launched(_counts(), before)
        _restore(before)
        if self._pool is None:
            self._pool = graph.pool()
        self._held.extend(scratch_buffers())
        return graph, counts

    def _guarded_warm_up(self) -> SimState:
        """The first GUARDED step, eagerly: the rebuild step and the
        refresh step from the same state, each field picked by the guard's
        predicate on the device, counted as settle() counts a replay."""
        st, cfg = self.state, self.cfg
        fire = _guard(st, cfg)
        if self._flag is None:
            self._flag = torch.zeros((1,), dtype=torch.int32,
                                     device=st.device)
            self._tally = torch.zeros((), dtype=torch.int32,
                                      device=st.device)
        before = _counts()
        with forced_rebuild(True):
            a = step(st, cfg)
        mid = _counts()
        with forced_rebuild(False):
            b = step(st, cfg)
        self._sides = (_launched(mid, before), _launched(_counts(), mid))
        _restore(before)
        self._tally.add_(fire.to(torch.int32))
        self._pending += 1
        return _pick(fire, a, b)

    def settle(self) -> None:
        """Add the launches of the GUARDED steps since the last settle to
        the counters: the tally's rebuild sides, the rest refresh sides
        (one read of the device tally: call it after the horizon)."""
        if not self._pending:
            return
        fired = int(self._tally)
        _add(self._sides[0], fired)
        _add(self._sides[1], self._pending - fired)
        self._tally.zero_()
        self._pending = 0


def rollout(state: SimState, cfg: SimConfig, num_steps: int,
            sample_every: int = 0):
    """Run `num_steps` steps. With `sample_every` > 0 returns
    (final_state, (pos [S, N, 3], quat [S, N, 4])) sampled every
    `sample_every` steps; otherwise (final_state, None).

    On a CUDA state the steps are replays of captured CUDA graphs
    (DeviceStepper; the first step of each branch runs eagerly before its
    capture), with no host↔device sync inside the horizon: the hull
    motion guard is decided on the device too, and its launch counts are
    settled after the last step. The samples are copied on the device. A
    capture that fails raises. On the CPU it is a loop of `step`. Both
    give what the loop gives."""
    if sample_every > 0 and num_steps % sample_every:
        raise ValueError("num_steps must be a multiple of sample_every")
    stepper = None
    if state.device.type == "cuda":
        stepper = DeviceStepper(state, cfg)
        advance = stepper.step
    else:
        def advance():
            nonlocal state
            state = step(state, cfg)
            return state
    pos, quats = [], []
    for k in range(num_steps):
        state = advance()
        if sample_every > 0 and (k + 1) % sample_every == 0:
            pos.append(state.pos.clone())
            quats.append(state.quat.clone())
    if stepper is not None:
        stepper.settle()
    if sample_every > 0:
        return state, (torch.stack(pos), torch.stack(quats))
    return state, None
