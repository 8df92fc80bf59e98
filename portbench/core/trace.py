"""The traced run's device trace: torch.profiler over whole calls of the
window's drive, after the window.

From the trace: every device operation (kernel, copy, memset) with its
start and end; the traced window; the seconds the device was busy (the
union of the operations' intervals, clipped to the window); the device
operations that took the most time; and the longest idle gaps, each
named by the innermost host operation running at its middle ("host"
where none)."""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from types import SimpleNamespace

import torch

WINDOW = "portbench.traced_calls"


def profile_calls(drive, calls: int) -> SimpleNamespace:
    """Profile `calls` calls of drive.timed_call() (each ends in a
    synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if drive.device.type == "cuda":
        torch.cuda.synchronize(drive.device)
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(calls):
                drive.timed_call()
    dev, host, win = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.name == WINDOW:
            # the range is mirrored on the device's timeline: not work
            if e.device_type != DeviceType.CUDA:
                win = (tr.start, tr.end)
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    if win is None:
        raise RuntimeError("trace: the traced window's range is missing")
    return reduce(dev, host, win)


def idle_between_calls(drive, seconds: float = 1.0):
    """The card's idle share (%) of unprofiled calls, run back to back for
    `seconds` (one at least): each call's device time from a CUDA event
    recorded before its first launch to one after its last, against the
    host's clock over all of them. The card is idle between calls, while
    the host synchronizes and starts the next one; a wait inside a call
    counts as busy. None off the card. (A profiler's trace cannot give
    this: on the H100 tracing the device's kernels adds 0.4–1.2 µs a
    kernel to the calls' wall time.)"""
    import time

    if drive.device.type != "cuda":
        return None
    pairs = []
    torch.cuda.synchronize(drive.device)
    t0 = time.perf_counter()
    while not pairs or time.perf_counter() - t0 < seconds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        drive.prog.call(drive.k)
        b.record()
        torch.cuda.synchronize(drive.device)
        drive.k += 1
        pairs.append((a, b))
    wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return 100.0 * (1.0 - busy_ms / wall_ms)


def reduce(dev, host, win) -> SimpleNamespace:
    """The trace's numbers from device events [(name, start µs, end µs)],
    host events and the window (start µs, end µs)."""
    w0, w1 = win
    spans = sorted((max(s, w0), min(e, w1)) for _, s, e in dev
                   if e > w0 and s < w1)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_op = defaultdict(float)
    for name, s, e in dev:
        by_op[name] += e - s
    gaps = []
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    by_gap = defaultdict(float)
    host = sorted(host, key=lambda h: h[1])
    starts = [s for _, s, _ in host]
    for a, b in gaps:
        by_gap[_innermost(host, starts, 0.5 * (a + b))] += b - a
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return SimpleNamespace(
        device_events=dev, window_us=w1 - w0, busy_us=busy,
        breakdown={"device_ops": [[n, us * 1e-6] for n, us in top],
                   "idle_gaps": [[n, us * 1e-6] for n, us in idle]})


def _innermost(host, starts, t: float, scan: int = 256) -> str:
    """The host operation running at t that started last (the innermost
    of nested ones), "host" where none."""
    i = bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - scan, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "host"


def group_us(trace, pattern) -> float | None:
    """Device µs of the traced operations whose name matches `pattern`
    (None where none ran)."""
    got = [e - s for n, s, e in trace.device_events if pattern.search(n)]
    return sum(got) if got else None
