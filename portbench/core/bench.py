"""One run of one cell: set-up, the measured window, the traced calls,
the correctness check, and the result line.

Set-up builds the scene from --seed, the program's state and one
engine.DeviceStepper, and runs the traffic's settle steps as whole calls
(the first call warms up and captures every branch of the step). The
window then drives the calls back to back, one client in a closed loop,
each ending in torch.cuda.synchronize(), for --seconds; it ends on the
synchronize of the last whole call."""

from __future__ import annotations

import gc
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.core import check, program as prog_mod, traffic
from portbench.core import trace as trace_mod
from portbench.reference.state import Config

FORBIDDEN = ("jax", "jaxlib", "flax", "physics_tpu")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loaded_forbidden() -> list:
    """The top-level modules of FORBIDDEN that this process has loaded,
    compared by whole top-level name (physics_tpu_torch is not
    physics_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Drive:
    """The program under one client, with the call counter k."""

    def __init__(self, spec, seed: int, device):
        self.spec = spec
        self.device = torch.device(device)
        conf = spec.conf
        self.arrays = spec.builder.make(conf["scene"], seed)
        self.schedule = traffic.Schedule(spec.traffic, conf["scene"], seed,
                                         spec.builder)
        self.ref = spec.reference
        self.cfg = prog_mod.program_config(conf)
        self.ref_cfg = Config(**conf["sim"])
        self.ref_cfg.gravity = tuple(self.ref_cfg.gravity)
        self.n = self.arrays["pos"].shape[0]
        self.k = 0
        self.capture_ms = None
        self.prog = None

    def build(self) -> None:
        if self.device.type == "cuda":
            prog_mod.load_kernels()
        self.prog = self.spec.call(self.cfg, self.arrays, self.schedule,
                                   self.device, self.ref.SNAPSHOT)

    def call(self) -> None:
        self.prog.call(self.k)
        self.k += 1

    def timed_call(self) -> float:
        t0 = time.perf_counter()
        self.prog.call(self.k)
        sync(self.device)
        self.k += 1
        return time.perf_counter() - t0

    def aligned(self, k: int) -> bool:
        """Call k starts on a scheduled rebuild."""
        s = self.schedule.steps_per_call
        return (k * s) % self.cfg.contact_rebuild == 0

    def host_case(self, k0: int) -> check.Case:
        """A case from call k0 with its host buffers (allocated now, so
        that the calls it compares only queue copies into them)."""
        sch = self.schedule
        case = check.Case(k0, sch.steps_per_call, sch.check_steps)
        case.bufs = {g: self.prog.host_buffers() for g in case.keep}
        case.out_bufs = {g: torch.empty(self.prog.out.shape,
                                        pin_memory=self.device.type == "cuda")
                         for g in case.compared if g % case.s == case.s - 1}
        return case

    def call_into(self, case: check.Case) -> None:
        """Call k, keeping the snapshots and outputs `case` compares."""
        c = self.k - case.k0
        if c == 0 and -1 in case.bufs:
            case.snaps[-1] = self.prog.snapshot_into(case.bufs[-1])

        def after_step(i):
            g = c * case.s + i
            if g in case.keep:
                case.snaps[g] = self.prog.snapshot_into(case.bufs[g])

        self.prog.call(self.k, after_step=after_step)
        g = c * case.s + case.s - 1
        if g in case.out_bufs:
            case.outs[g] = case.out_bufs[g].copy_(self.prog.out,
                                                  non_blocking=True)
        self.k += 1

    def settle(self) -> check.Case:
        """Set-up's calls: the first warms up and captures every branch of
        the step (capture_ms); the first ones are the start case
        of the check. Returns it."""
        sch = self.schedule
        start = self.host_case(0)
        if sch.settle_calls <= start.last_call():
            raise ValueError("traffic: set-up settles fewer calls than "
                             "the check compares")
        del start.bufs[-1]
        start.snaps[-1] = None
        self.call_into(start)
        if self.prog.capture_ms is None:
            raise RuntimeError(f"set-up's first call captured only "
                               f"{sorted(map(str, self.prog.branches))}")
        self.capture_ms = self.prog.capture_ms
        while self.k <= start.last_call():
            self.call_into(start)
        while self.k < sch.settle_calls:
            self.call()
        sync(self.device)
        return start


def sample_call(drive: Drive, seed: int) -> int:
    """The window's compared call: drawn from the seed among its first 16
    calls, moved on to the next that starts on a scheduled rebuild."""
    j = drive.k + int(np.random.default_rng([seed, 99]).integers(0, 16))
    while not drive.aligned(j):
        j += 1
    return j


def window(drive: Drive, seconds: float, j: int):
    """The closed loop for `seconds`: (per-call seconds, end times from
    the window's start, window seconds, the sampled case). The sampled
    calls keep their snapshots, inside their own time."""
    case = drive.host_case(j)
    durs, ends = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if case.k0 <= drive.k <= case.last_call():
            drive.call_into(case)
            sync(drive.device)
            durs.append(time.perf_counter() - t0)
        else:
            durs.append(drive.timed_call())
        t = time.perf_counter() - t_start
        ends.append(t)
        if t >= seconds and drive.k > case.last_call():
            break
    return durs, ends, ends[-1], case


def e2e(drive: Drive, durs, ends, window_s, setup_s) -> dict:
    calls = len(durs)
    work = drive.n * drive.schedule.steps_per_call
    half = window_s / 2
    first = sum(1 for t in ends if t <= half)
    top = sorted(durs)[-3:]
    log(f"window: {calls} calls in {window_s:.4f} s; slowest calls ms "
        f"{', '.join(f'{1e3 * d:.3f}' for d in top)}; rate first half "
        f"{work * first / half:.1f}, second half "
        f"{work * (calls - first) / (window_s - half):.1f} body-steps/s; "
        f"call ms median {1e3 * statistics.median(durs):.4f}, max "
        f"{1e3 * max(durs):.4f}")
    return {"body_steps_per_s": work * calls / window_s,
            "call_ms_p95": 1e3 * float(np.percentile(durs, 95)),
            "setup_s": setup_s}


def traced(drive: Drive):
    """The card's idle share between unprofiled calls, then trace_calls
    calls profiled from the next aligned one: (the trace, the snapshot at
    their start, the first traced call)."""
    idle = trace_mod.idle_between_calls(drive)
    if idle is not None:
        log(f"device idle between calls: {idle:.4f}% (CUDA events, "
            f"unprofiled calls)")
    while not drive.aligned(drive.k):
        drive.timed_call()
    k0 = drive.k
    snap = drive.prog.snapshot_into(drive.prog.host_buffers())
    sync(drive.device)
    tr = trace_mod.profile_calls(drive, drive.schedule.trace_calls)
    tr.idle_pct = idle
    return tr, snap, k0


def least_times(drive: Drive, base, snap, k0) -> dict:
    """{metric: its least ms over the traced calls, None where it has
    none}: each roofline reader's `least` on the inputs of every step,
    as the reference follows the traced calls from their start."""
    hooks = {name: mod.least for name, mod in drive.spec.readers.items()
             if hasattr(mod, "least")}
    acc = {name: [0.0, 0, set()] for name in hooks}

    def on_step(st, cfg, s):
        for name, least in hooks.items():
            b = least(st, cfg, s)
            if b is not None:
                acc[name][0] += b[0]
                acc[name][1] += 1
                acc[name][2].add(b[1])

    sch, ref = drive.schedule, drive.ref
    if hooks:
        rs = ref.from_snapshot(base, check.on_device(snap, base.device))
        for k in range(k0, k0 + sch.trace_calls):
            for _ in range(sch.steps_per_call):
                rs = ref.step(rs, drive.ref_cfg, on_step=on_step)
            rs = check.apply_resets(ref, rs, sch, k)
    for name, (ms, steps, binds) in acc.items():
        log(f"least time {name}: {ms:.6f} ms over {steps} steps "
            f"({'/'.join(sorted(binds)) or '-'})")
    return {k: (v[0] if v[1] else None) for k, v in acc.items()}


def run_cell(spec, seed: int, seconds: float, trace: bool, device,
             t0: float, control: bool = False) -> dict:
    """One run. Returns {correct, numbers, metrics, device, breakdown,
    attempted, ...}."""
    marks = [("imports and the card's context", time.perf_counter())]
    drive = Drive(spec, seed, device)
    marks.append(("inputs", time.perf_counter()))
    drive.build()
    marks.append(("kernels and state", time.perf_counter()))
    start_case = drive.settle()
    j = sample_call(drive, seed)
    setup_s = time.perf_counter() - t0
    marks.append(("settle", time.perf_counter()))
    prev = t0
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log(f"set-up s: {'; '.join(parts)} (capture {drive.capture_ms:.1f} "
        f"ms of the settle)")
    sampler = None
    if drive.device.type == "cuda":
        from portbench.core import smi
        sampler = smi.Sampler()
    captures0 = drive.prog.captures
    try:
        durs, ends, window_s, sample = window(drive, seconds, j)
    finally:
        samples = sampler.stop() if sampler else []
    captures = drive.prog.captures - captures0
    for line in samples:
        log(f"nvidia-smi: {line}")
    log(f"branches captured in set-up: {sorted(map(str, drive.prog.branches))};"
        f" captures in the window: {captures}; bodies reset a call: "
        f"{sorted({drive.schedule.bodies_reset(k) for k in range(drive.k)})}")
    metrics = e2e(drive, durs, ends, window_s, setup_s)
    # the process's peak, set-up and window, before the reference runs
    mem = (torch.cuda.max_memory_allocated(drive.device)
           if drive.device.type == "cuda" else 0)
    tr = tsnap = None
    if trace:
        tr, tsnap, tk0 = traced(drive)
    drive.prog.close()
    drive.prog = None
    gc.collect()
    if drive.device.type == "cuda":
        torch.cuda.empty_cache()
    # the reference, once the window has closed and the program is freed
    base = drive.ref.initial_state(drive.arrays, drive.ref_cfg,
                                   drive.device)
    cases = [start_case, sample]
    numbers = check.compare(drive.ref, base, drive.ref_cfg, drive.schedule,
                            cases, control=control)
    out = SimpleNamespace(
        correct=check.verdict(numbers, spec.limits), numbers=numbers,
        limits=spec.limits, metrics=metrics, attempted=len(durs),
        captures=captures, memory_peak_bytes=mem, trace=tr, breakdown=None,
        per_layer={}, capture_ms=drive.capture_ms)
    if trace:
        least = least_times(drive, base, tsnap, tk0)
        for m in spec.per_layer:
            ctx = SimpleNamespace(
                trace=tr, least=least.get(m["name"]),
                steps=(drive.schedule.trace_calls
                       * drive.schedule.steps_per_call),
                capture_ms=drive.capture_ms)
            v = spec.readers[m["name"]].read(ctx)
            if v is not None:
                out.per_layer[m["name"]] = v
        out.breakdown = tr.breakdown
        for kind in ("device_ops", "idle_gaps"):
            for name, s in tr.breakdown[kind]:
                log(f"trace {kind}: {s:.6f} s {name[:100]}")
    return out
