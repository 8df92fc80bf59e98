"""Stage spans and device counters of the step, off by default.

One switch, `enable(bool)`. A step runs these stages one after another,
each until the next boundary (`stage(name, device)`):

    forces     gravity, the joints and their CG, the velocity integration
    pairs      body_aabbs, sweep_order, pair_candidates (2.1), unified_geom
    table      refresh_prep, the contact table (2.2 / 2.4) or the persisted
               table's warm rows, the overflow counters (the generic
               box branch: its contact list)
    solve      table_keys and the solve (2.3; 2.5 / 2.7)
    writeback  the solve's outputs in body order, the step's last fields,
               DeviceStepper's copy into its static buffers
    end        after the step (DeviceStepper: after that copy, the step's
               own end held by `end_held`)

The generic hull path (solver.contacts.hull_contact_list, under
scenes.rain_xla_config) opens no `table` stage: its contact list, between
`pairs` and `solve`, runs four sub-stages, appended to STAGES after `end`
so that the IDs above stay as they are:

    list_ground     the hull vertices on the ground (ground_contacts)
    list_prefilter  the OBB prefilter and its compaction
    list_manifolds  a type-pair segment's slot-major SAT manifolds
                    (hullhull_batched.shared_hull_manifolds_sm); on the
                    card every segment's SAT, manifolds and picks
                    (ops/hull_list.py, csrc/hull_list.cu)
    list_select     that segment's kk argmax picks
                    (narrowphase._hull_fast_select_rows), then the list's
                    assembly (the slot and rank rows, concat_contacts)

With several hull types list_manifolds and list_select alternate, once a
segment, in the plain version; the kernel path opens list_manifolds once
and list_select for the assembly.

Off, a boundary is one check of a module-level boolean. On, it closes
the open `torch.profiler.record_function` range and opens `pt.<stage>`
(none after `end`), and on a CUDA device it launches a one-thread marker
kernel, `stage_mark<ID>` (csrc/trace.cu, ID the stage's index in
STAGES), on the current stream. A marker launched while a CUDA graph is
captured is a node of the graph, so in a profiled replay, where no
Python runs, the device operations between one marker and the next are
that marker's stage. The host ranges and the markers come from one
profiler and share its clock.

Counters: DeviceStepper keeps an int64 vector on the device, one slot a
name of COUNTERS. Its `guarded_rebuilds` slot is always on (the GUARDED
steps whose rebuild side ran); `count(name, value)` adds to the others
only while tracing is on and a stepper has put its vector in place
(`counting`): on the generic hull path `list_slots` (the contact list's
length C), `list_live` (its active contacts), `prefilter_dropped` (the
OBB prefilter's survivors it had no lane for) and `band_dropped` (the
banded solve's band_overflow: active contacts out of their window), as
well as the gate's, the hull table's and the generic hull path's pair
contacts' (list_sat_lanes, list_sat_pass: ops/hull_list.py). `slots(name, n)` hands a kernel that counts on the
device itself a view of them under the same condition (None otherwise,
and the kernel counts nothing), so a graph captured with tracing off
holds none of their operations. DeviceStepper also opens host ranges
around its replays, warm-up steps and captures (`span`).

Enable tracing before a stepper captures its branches (or call its
recapture() after): the graphs hold what was on when they were
captured."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

STAGES = ("forces", "pairs", "table", "solve", "writeback", "end",
          "list_ground", "list_prefilter", "list_manifolds", "list_select")
# the stepper's device counters: the GUARDED rebuild tally; the buckets
# a gated refresh fired, and those it evaluated; the hull table's SAT
# lanes (2.4), and those whose SAT found the hulls overlapping; the
# generic hull path's contact slots, live contacts, prefilter drops and
# band drops, and its pair contacts' SAT lanes (cand.mask) and those whose
# SAT found the hulls overlapping
COUNTERS = ("guarded_rebuilds", "gate_fired", "gate_buckets",
            "hull_sat_lanes", "hull_sat_pass", "list_slots", "list_live",
            "prefilter_dropped", "band_dropped", "list_sat_lanes",
            "list_sat_pass")

_on = False
_open = None          # the open pt.<stage> range
_current = None       # the stage begun last
_NULL = contextlib.nullcontext()
_COUNTERS: contextvars.ContextVar = contextvars.ContextVar(
    "tracing_counters", default=None)
_END_HELD: contextvars.ContextVar = contextvars.ContextVar(
    "tracing_end_held", default=False)


def enable(on: bool) -> None:
    """Turn tracing on or off (off closes the open stage range)."""
    global _on, _current
    if not on:
        _close()
        _current = None
    _on = bool(on)


def stage(name: str, device: torch.device) -> None:
    """The next stage of the step starts here (see the module
    docstring); a boundary of the stage already begun adds nothing."""
    if _on:
        _mark(name, device)


def _close() -> None:
    global _open
    if _open is not None:
        _open.__exit__(None, None, None)
        _open = None


def _mark(name: str, device: torch.device) -> None:
    global _open, _current
    idx = STAGES.index(name)
    if name == _current or (name == "end" and _END_HELD.get()):
        return
    _current = name
    _close()
    if name != "end":
        _open = torch.profiler.record_function(f"pt.{name}")
        _open.__enter__()
    _launch(idx, device)


def _launch(idx: int, device: torch.device) -> None:
    """stage_mark<idx> on the current stream of a CUDA `device` (nothing
    elsewhere)."""
    if device.type != "cuda":
        return
    from physics_tpu_torch import _build

    _build.check(_build.library().tr_stage_mark(
        idx, torch.cuda.current_stream(device).cuda_stream),
        "stage_mark")


@contextlib.contextmanager
def end_held() -> Iterator[None]:
    """Within the block an `end` boundary adds nothing: the caller marks
    the step's end itself (DeviceStepper, after its copy)."""
    token = _END_HELD.set(True)
    try:
        yield
    finally:
        _END_HELD.reset(token)


def span(kind: str, branch=None):
    """A host range `pt.<kind>` (`pt.<kind>.<branch>` with a branch)
    while tracing is on; a shared null context while it is off."""
    if not _on:
        return _NULL
    name = f"pt.{kind}" if branch is None else f"pt.{kind}.{branch}"
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def counting(counters: torch.Tensor) -> Iterator[None]:
    """Within the block count() adds to `counters` (int64 [len(COUNTERS)],
    DeviceStepper's)."""
    token = _COUNTERS.set(counters)
    try:
        yield
    finally:
        _COUNTERS.reset(token)


def slots(name: str, n: int = 1) -> torch.Tensor | None:
    """The `n` counters from `name` on (in COUNTERS' order) of the vector
    in place, a view, while tracing is on; None otherwise."""
    if not _on:
        return None
    sink = _COUNTERS.get()
    if sink is None:
        return None
    i = COUNTERS.index(name)
    return sink[i:i + n]


def count(name: str, value) -> None:
    """Add `value` (a tensor's sum, or an int) to the counter `name` of
    the vector in place, while tracing is on."""
    sink = slots(name)
    if sink is not None:
        if isinstance(value, torch.Tensor):
            value = value.sum()
        sink[0].add_(value)
