"""The program's own stage spans and device counters in a --trace 1 run
(physics_tpu_torch.tracing): the step's glue split by stage, and the
share of buckets the gated refresh fires.

Importing this module (the readers of glue_<stage>_us_per_step and
gate_fired_pct do) wraps bench.traced: after the traced calls that the
other per-layer metrics read, whose graphs were captured with tracing
off, and before the program is closed, `measure` runs on the same drive
and its result hangs on the trace as `spans`. It

1. times unprofiled calls of the graphs captured in set-up;
2. makes the call shape's stepper capture its branches again
   (DeviceStepper.recapture, then calls until every branch is
   captured), and times as many calls: a new capture alone can move a
   call by 10% or more (other addresses in a new memory pool);
3. turns tracing on, captures again, resets the stepper's device
   counters and times as many calls: against step 2, the cost of
   tracing;
4. profiles trace_calls calls from the next that starts on a scheduled
   rebuild, and reduces them (`reduce`);

then turns tracing off. On a program without the tracing module, or a
call shape without a stepper that recaptures, it returns None and runs
nothing: the readers then find nothing to read.

The reduction: each device operation that is not a marker
(stage_mark<ID>) and not one of the port's own kernels (core/yardstick.py
PORT), put to the stage of the last marker that started before it; an
operation before the first marker or after an `end` marker is
unattributed (the call shape's resets and output gather). Device µs a
traced step by stage; the idle gaps of the profiled calls named by the
innermost pt.* host range open at each gap's middle, "harness" where
none is."""

from __future__ import annotations

import re
import statistics
import time
from bisect import bisect_right
from collections import defaultdict
from types import SimpleNamespace

from portbench.core import bench
from portbench.core import trace as trace_mod
from portbench.core.yardstick import PORT

MARK = re.compile(r"stage_mark<(\d+)>")
WINDOW = "portbench.span_calls"
TIMED_S = 1.0           # unprofiled calls timed on each side of the cost


def _program():
    """The program's tracing module, None where it has none."""
    try:
        from physics_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def _call_ms(drive, calls: int) -> list:
    """Host ms of unprofiled calls, `calls` at least and TIMED_S s."""
    out = []
    t0 = time.perf_counter()
    while len(out) < calls or time.perf_counter() - t0 < TIMED_S:
        out.append(1e3 * drive.timed_call())
    return out


def _profiled(drive, calls: int):
    """Device events, the pt.* host ranges and the window of `calls`
    profiled calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if drive.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    bench.sync(drive.device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(calls):
                drive.timed_call()
    dev, host, win = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the host ranges are mirrored on the device's timeline: not
            # work
            if e.name != WINDOW and not e.name.startswith("pt."):
                dev.append((e.name, tr.start, tr.end))
        elif e.name == WINDOW:
            win = (tr.start, tr.end)
        elif e.name.startswith("pt."):
            host.append((e.name, tr.start, tr.end))
    return dev, host, win


def measure(drive, tr) -> SimpleNamespace | None:
    """Steps 1-4 of the module docstring on `drive` after bench.traced
    (`tr`, its trace, for the glue it read); None where the program has
    no stage spans."""
    tracing = _program()
    stepper = getattr(drive.prog, "stepper", None)
    if tracing is None or not hasattr(stepper, "recapture"):
        return None
    sch = drive.schedule
    setup_log = list(stepper.capture_log)
    branches = set(stepper.captured)

    def recaptured():
        stepper.recapture()
        for _ in range(1000):
            if stepper.captured == branches:
                return
            drive.timed_call()
        raise RuntimeError(f"spans: recaptured only "
                           f"{sorted(map(str, stepper.captured))}")

    setup = _call_ms(drive, sch.trace_calls)
    recaptured()
    off = _call_ms(drive, sch.trace_calls)
    tracing.enable(True)
    try:
        recaptured()
        stepper.reset_counters()
        on = _call_ms(drive, sch.trace_calls)
        while not drive.aligned(drive.k):
            drive.timed_call()
        dev, host, win = _profiled(drive, sch.trace_calls)
        counters = stepper.counters()
    finally:
        tracing.enable(False)
    steps = sch.trace_calls * sch.steps_per_call
    out = reduce(dev, host, win, steps, tracing.STAGES)
    out.counters = counters
    out.capture_log = setup_log
    out.recapture_log = stepper.capture_log[len(setup_log):]
    out.call_ms = tuple(statistics.median(x) for x in (setup, off, on))
    _log(out, tr, sch.steps_per_call, steps)
    return out


def reduce(dev, host, win, steps: int, stages) -> SimpleNamespace:
    """Device µs a step by stage of the glue in `dev` [(name, start µs,
    end µs)] (see the module docstring) and its operations a step, the
    markers' and each port kernel's own µs a step, and
    the idle gaps of the window `win` named by the pt.* ranges in
    `host`."""
    marks = sorted((s, int(m.group(1))) for n, s, _ in dev
                   if (m := MARK.search(n)))
    starts = [s for s, _ in marks]
    by, ops, port = defaultdict(float), defaultdict(int), defaultdict(float)
    for n, s, e in dev:
        if MARK.search(n):
            by["markers"] += e - s
        elif PORT.search(n):
            port[_kernel(n)] += e - s
        else:
            i = bisect_right(starts, s) - 1
            name = stages[marks[i][1]] if i >= 0 else "end"
            name = "unattributed" if name == "end" else name
            by[name] += e - s
            ops[name] += 1
    per_step = {k: v / steps for k, v in by.items()}
    gaps = []
    if win is not None:
        named = trace_mod.reduce(dev, host, win).breakdown["idle_gaps"]
        gaps = [["harness" if n == "host" else n, s] for n, s in named]
    return SimpleNamespace(
        stage_us={k: per_step.get(k, 0.0) for k in stages if k != "end"}
        if marks else {},
        stage_ops={k: ops[k] / steps for k in stages if k != "end"},
        unattributed_us=per_step.get("unattributed", 0.0),
        markers_us=per_step.get("markers", 0.0), idle_gaps=gaps,
        port_us={k: v / steps for k, v in sorted(port.items())})


def _kernel(name: str) -> str:
    """A port kernel's name without its namespace, template arguments
    and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0]


def _log(out, tr, steps_per_call: int, steps: int) -> None:
    glue = sum(e - s for n, s, e in tr.device_events if not PORT.search(n))
    total = sum(out.stage_us.values())
    bench.log(f"spans: glue by stage, device us a step: "
              + "; ".join(f"{k} {v:.3f}" for k, v in out.stage_us.items())
              + f"; sum {total:.3f}; unattributed "
              f"{out.unattributed_us:.3f}; markers {out.markers_us:.3f}; "
              f"the traced calls' glue (tracing off) {glue / steps:.3f}; "
              f"operations a step: " + "; ".join(
                  f"{k} {v:.2f}" for k, v in out.stage_ops.items()))
    setup, off, on = out.call_ms
    bench.log(f"spans: call ms median, set-up's graphs {setup:.4f}, "
              f"captured again with tracing off {off:.4f}, on {on:.4f}: "
              f"tracing costs {1e3 * (on - off) / steps_per_call:.3f} us a "
              f"step ({100.0 * (on - off) / off:.3f}% of a call), the new "
              f"capture alone {1e3 * (off - setup) / steps_per_call:.3f}")
    for name, us in out.port_us.items():
        was = sum(e - s for n, s, e in tr.device_events
                  if PORT.search(n) and _kernel(n) == name)
        bench.log(f"spans: port kernel {name} us a step: traced calls "
                  f"{was / steps:.3f}, span pass {us:.3f}")
    bench.log(f"spans: counters {out.counters}")
    for what, entries in (("set-up", out.capture_log),
                          ("again, tracing off then on", out.recapture_log)):
        bench.log(f"spans: captures ({what}): " + "; ".join(
            f"{b} warm-up {w:.3f} ms capture {c:.3f} ms"
            for b, w, c in entries))
    for name, s in out.idle_gaps:
        bench.log(f"spans: idle gap {s:.6f} s {name[:100]}")


def stage_us(ctx, stage: str):
    """A stage's glue, device µs a step, from the run's spans (None
    where there are none)."""
    spans = getattr(ctx.trace, "spans", None)
    if spans is None or stage not in spans.stage_us:
        return None
    return spans.stage_us[stage]


def gate_fired_pct(ctx):
    """100 × gate_fired ÷ gate_buckets over the spans' calls (None where
    no gate ran)."""
    spans = getattr(ctx.trace, "spans", None)
    if spans is None or not spans.counters.get("gate_buckets"):
        return None
    c = spans.counters
    return 100.0 * c["gate_fired"] / c["gate_buckets"]


def _traced_with_spans(drive):
    tr, snap, k0 = _traced(drive)
    tr.spans = measure(drive, tr)
    return tr, snap, k0


if not hasattr(bench.traced, "spans_wrapped"):
    _traced = bench.traced
    _traced_with_spans.spans_wrapped = True
    _traced_with_spans.__doc__ = (_traced.__doc__ or "") + (
        " Then core/spans.py's measure, as the trace's `spans`.")
    bench.traced = _traced_with_spans
