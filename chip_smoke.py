"""GPU smoke run of physics_tpu_torch: the 4,096-body box pile stepping on
one NVIDIA card through the port's three hand-written kernels.

    python3 chip_smoke.py            # needs CUDA; exits non-zero without

Phases (any failure raises, so the run exits non-zero):
  1. card     name and power limit (nvidia-smi);
  2. build    compile csrc/*.cu with nvcc and print ptxas's per-kernel
              report (the Triton kernel compiles at its first launch);
  3. kernels  each kernel against its plain PyTorch version, on the card,
              at the main path's shapes (a pile settled by 60 steps), with
              median times from CUDA events;
  4. slice    prepare_contacts + 240 steps of pile_config(4096) with
              contact_iters=8 through step_with_metrics: launch counts,
              finite state, overflow counters, one rebuild and one refresh
              step of the kernel path against the plain path, the step
              rate over a timed window, and device time by kernel over 8
              more steps (torch.profiler).
The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from physics_tpu_torch import _build, scenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.ops.broadphase import (
    body_aabbs,
    pair_candidates,
    sweep_order,
)
from physics_tpu_torch.ops.contact_table import (
    CT_ACT,
    CT_KH,
    CT_KL,
    CT_KS,
    CT_KSGN,
    CT_MU,
    CT_RA,
    CT_RB1,
    CT_REST,
    bucket_contact_table,
    unified_geom,
)
from physics_tpu_torch.ops.sweep_kernel import sweep_window_masks
from physics_tpu_torch.solver.banded_solve import banded_sweeps_fused
from physics_tpu_torch.state import SHAPE_NONE

EXACT_ROWS = [CT_ACT, CT_KL, CT_KH, CT_KSGN, CT_RA, CT_RB1, CT_KS, CT_MU,
              CT_REST]
# kernel vs plain on the card. The contact table computes the same f32
# operations in the same order (nvcc -fmad=false), so it should agree to
# the bit; 1e-5 of the scene extent is allowed. The solve sums impulse
# deltas with atomics in a run-dependent order: 1e-4 of each output row's
# largest magnitude, and 1e-4 absolute for one whole step's state.
SOLVE_RTOL = 1e-4
STEP_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    line = smi.splitlines()[torch.cuda.current_device()]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return line


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def row_check(name, got, ref, rtol):
    """max |got − ref| over rows, each within rtol · max(|ref row|, 1e-3)."""
    err = 0.0
    for r in range(ref.shape[0]):
        d = float((got[r] - ref[r]).abs().max())
        tol = rtol * max(float(ref[r].abs().max()), 1e-3)
        if not d <= tol:
            raise AssertionError(f"{name} row {r}: |Δ| {d} > {tol}")
        err = max(err, d)
    return err


def check_kernels(state, cfg):
    """Phase 3: each kernel against its plain version at the pile's
    shapes. Returns {name: (max_abs_err, ms, plain_ms)}."""
    n = state.num_bodies
    out = {}
    aabbs = body_aabbs(state)
    order = sweep_order(state, aabbs)
    oi = order.long()
    aabb_s = aabbs[oi].contiguous()
    coll_s = (state.shapes.stype != SHAPE_NONE)[oi].contiguous()
    k = min(cfg.sweep_window, n - 1)
    mk, lk = sweep_window_masks(aabb_s, coll_s, k)
    mp, lp = sweep_window_masks(aabb_s, coll_s, k, plain=True)
    if not (torch.equal(mk, mp) and torch.equal(lk, lp)):
        raise AssertionError("sweep masks differ from the plain version")
    log(f"2.1 sweep masks: identical ({int(mk.sum())} overlaps, "
        f"{int(lk.sum())} window-edge ranks)")
    out["sweep_window_masks"] = (0.0, median_ms(
        lambda: sweep_window_masks(aabb_s, coll_s, k), 50), median_ms(
        lambda: sweep_window_masks(aabb_s, coll_s, k, plain=True), 10))

    cand = pair_candidates(state, cfg, aabbs, order)
    geom = unified_geom(state, cfg, order)
    prev = (state.contact_key, state.contact_lam)
    tk, mtk, wk = bucket_contact_table(state, cand, cfg, prev=prev,
                                       geom=geom)
    tp, mtp, wp = bucket_contact_table(state, cand, cfg, prev=prev,
                                       geom=geom, plain=True)
    for r in EXACT_ROWS:
        if not torch.equal(tk[r], tp[r]):
            raise AssertionError(f"contact table row {r} differs")
    if not (torch.equal(mtk, mtp) and torch.equal(wk, wp)):
        raise AssertionError("contact table meta/warm rows differ")
    extent = float(geom[0:3, :n].abs().max())
    err_t = float((tk - tp).abs().max())
    if not err_t <= 1e-5 * extent:
        raise AssertionError(f"contact table f32 rows: |Δ| {err_t}")
    meta = mtk[0].reshape(-1, 128)
    log(f"2.2 contact table: keys/activity/ranks/meta/warm identical, f32 "
        f"rows max |Δ| {err_t} (tol {1e-5 * extent:.3g}); "
        f"{int(tk[CT_ACT].sum())} contacts, dropped {int(meta[:, 0].sum())},"
        f" prefilter drops {int(meta[:, 2].sum())}")
    out["bucket_contact_table"] = (err_t, median_ms(
        lambda: bucket_contact_table(state, cand, cfg, prev=prev,
                                     geom=geom), 20), median_ms(
        lambda: bucket_contact_table(state, cand, cfg, prev=prev,
                                     geom=geom, plain=True), 3))

    # 2.3 on the rebuild schedule (fresh table + warm rows) and on the
    # refresh schedule (the state's persisted table and rank order)
    cp = tk.shape[1]
    r_it = cfg.contact_refresh_iters
    geom_r = unified_geom(state, cfg, state.contact_order)
    warm_r = torch.cat([state.contact_lam, torch.zeros(
        (5, cp), device=geom.device)])
    cases = {"rebuild": (tk, wk, geom, cfg.contact_iters),
             "refresh": (state.contact_table, warm_r, geom_r, r_it)}
    err_s = 0.0
    times = {}
    for label, (tab, warm, g, it) in cases.items():
        def run(plain, tab=tab, warm=warm, g=g, it=it):
            return banded_sweeps_fused(
                tab, warm, g, cfg, vel_iters=it, pos_iters=it,
                use_split=True, integrate=(cfg.dt, True), plain=plain)
        zk, lk4, pk = run(False)
        zp, lp4, pp = run(True)
        e = max(row_check(f"solve {label} z", zk[:, :n], zp[:, :n],
                          SOLVE_RTOL),
                row_check(f"solve {label} lam", lk4, lp4, SOLVE_RTOL),
                row_check(f"solve {label} posq", pk[:, :n], pp[:, :n],
                          SOLVE_RTOL))
        err_s = max(err_s, e)
        times[label] = (median_ms(lambda: run(False), 20),
                        median_ms(lambda: run(True), 3))
        log(f"2.3 banded solve ({label}, {it + 1} sweeps): "
            f"max |Δ| {e}; kernel {times[label][0]:.4f} ms, plain "
            f"{times[label][1]:.4f} ms")
    out["banded_sweeps_fused"] = (err_s,) + times["rebuild"]
    return out


def state_close(a, b, what):
    for name in ("pos", "quat", "vel", "omega"):
        d = float((getattr(a, name) - getattr(b, name)).abs().max())
        if not d <= STEP_ATOL:
            raise AssertionError(f"{what}: {name} |Δ| {d} > {STEP_ATOL}")
    if not torch.equal(a.contact_key, b.contact_key):
        raise AssertionError(f"{what}: contact keys differ")


def profile_steps(state, cfg, steps: int) -> None:
    """Device time by kernel over `steps` steps (torch.profiler), and the
    device's busy share of the profiled wall time (which the profiler's
    own overhead lengthens, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_with_metrics(state, cfg)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): the host operators that
    # launched them report the same device time again
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile over {steps} steps: device busy {busy / steps:.1f} us/step"
        f" of {wall_us / steps:.1f} us/step wall ({100 * busy / wall_us:.1f}%"
        f" busy), {sum(r[1] for r in rows) / steps:.0f} device ops/step")
    for us, count, key in rows[:15]:
        log(f"  {us / steps:9.1f} us/step  {count / steps:6.1f}/step  "
            f"{key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settle", type=int, default=60)
    ap.add_argument("--steps", type=int, default=240)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = card()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    path, nvcc_s, report = _build.build()
    _build.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {nvcc_s:.1f} s)")
    if report:
        log(report.strip())       # ptxas: registers, stack, spills

    n = 4096
    cfg = scenes.pile_config(n).replace(contact_iters=8)

    def pile():
        return scenes.box_pile(n, x_aspect=16.0, device=dev)

    # ---- phase 3: kernels against their plain versions ----
    st = prepare_contacts(pile(), cfg)
    for _ in range(args.settle):
        st, m = step_with_metrics(st, cfg)
    torch.cuda.synchronize()
    log(f"settled {args.settle} steps: contacts {int(m['contact_count'])}")
    results = check_kernels(st, cfg)

    # ---- phase 4: the slice ----
    counted = (sweep_window_masks, bucket_contact_table, banded_sweeps_fused)
    for fn in counted:
        fn.launches = 0
    st = prepare_contacts(pile(), cfg)
    window0 = min(40, args.steps // 2)
    torch.cuda.synchronize()
    for i in range(args.steps):
        if i == window0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        st, m = step_with_metrics(st, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    timed = args.steps - window0
    rebuilds = -(-args.steps // cfg.contact_rebuild)
    want = {"sweep_window_masks": rebuilds, "bucket_contact_table": rebuilds,
            "banded_sweeps_fused": args.steps}
    log(f"launches over {args.steps} steps: {launches}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for name in ("pos", "quat", "vel", "omega"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"non-finite {name} after the run")
    log(f"state finite; pair_overflow {int(m['pair_overflow'])}, "
        f"contact_overflow {int(m['contact_overflow'])}, max_penetration "
        f"{float(m['max_penetration']):.4f}, contacts "
        f"{int(m['contact_count'])}")
    ms = 1e3 * secs / timed
    log(f"slice: {ms:.4f} ms/step, {n * timed / secs:.1f} body-steps/s "
        f"over steps {window0}..{args.steps} on {gpu}")

    # one rebuild step (step_count % 4 == 0) and one refresh step, kernel
    # path against plain path from identical states
    for what in ("rebuild", "refresh"):
        sk, mk = step_with_metrics(st, cfg)
        sp, mp = step_with_metrics(st, cfg, plain=True)
        state_close(sk, sp, f"{what} step (step {st.step_count_host})")
        for key in ("contact_count", "pair_overflow", "contact_overflow"):
            if int(mk[key]) != int(mp[key]):
                raise AssertionError(f"{what} step: {key} differs")
        log(f"{what} step {st.step_count_host}: kernel path matches plain "
            f"path (atol {STEP_ATOL})")
        st = sk
    profile_steps(st, cfg, 8)

    sources = {
        "sweep_window_masks": ("triton", "physics_tpu_torch/ops/sweep_kernel.py",
                               "physics_tpu/ops/sweep_pallas.py:61"),
        "bucket_contact_table": ("cuda", "physics_tpu_torch/csrc/contact_table.cu",
                                 "physics_tpu/ops/contact_table.py:844"),
        "banded_sweeps_fused": ("cuda", "physics_tpu_torch/csrc/banded_solve.cu",
                                "physics_tpu/solver/contacts_pallas.py:736"),
    }
    kernels = []
    for name, (route, src, rep) in sources.items():
        err, kms, pms = results[name]
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": err, "ms": kms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
