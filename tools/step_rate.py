"""Step rate of the port's paths on one NVIDIA card, for two checkouts of
the repository compared in one run.

    python3 tools/step_rate.py --compare OLD_DIR NEW_DIR --rounds 2 \
        --paths pile rain two_kernel_pile

runs each checkout in its own process, in the order old, new, new, old
for each round, and prints one JSON line per process and a summary per
path. Each process builds its checkout's kernels (its own git-ignored
`physics_tpu_torch/_build/`), then for each path and each of `--reps`
fresh scenes times steps 40..240 on the host clock, ending in a device
synchronize, as chip_smoke.py phases 4, 5 and 7 do: `pile` is
`box_pile(4096, x_aspect=16)` under `pile_config(4096)` with
contact_iters=8 (the table path), `two_kernel_pile` the same with
contact_table=False, `rain` `mesh_rain(1024)` under `rain_config(1024)`.
With `--replayed` the steps are those engine.rollout runs on the card,
replays of captured CUDA graphs (engine.DeviceStepper), as chip_smoke.py
phase 12 times them. With `--profile`, each process then runs 8 steps of the first path under
torch.profiler and times `--reps` more of its scenes, to show whether a
finished profiler session changes the rate. With `--cprofile`, each
process also prints the host functions that take the most of 40 steps of
the first path under cProfile.

    python3 tools/step_rate.py --build-times

times the kernel build of this checkout two ways on the same sources:
one nvcc process per source, all started together (physics_tpu_torch/
_build.py), and one nvcc process over every source into one library.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


PATHS = ("pile", "rain", "two_kernel_pile")


def worker(root: str, paths, reps: int, profile: bool,
           cprofile: bool, replayed: bool) -> dict:
    sys.path.insert(0, root)
    import torch

    from physics_tpu_torch import scenes
    from physics_tpu_torch.engine import (
        DeviceStepper,
        prepare_contacts,
        step_with_metrics,
    )
    from physics_tpu_torch.solver.contacts import anchored_path

    dev = torch.device("cuda", 0)
    steps, window0 = 240, 40
    pile_cfg = scenes.pile_config(4096).replace(contact_iters=8)
    setups = {
        "pile": (lambda: scenes.box_pile(4096, x_aspect=16.0, device=dev),
                 pile_cfg),
        "two_kernel_pile": (lambda: scenes.box_pile(4096, x_aspect=16.0,
                                                    device=dev),
                            pile_cfg.replace(contact_table=False)),
        "rain": (lambda: scenes.mesh_rain(1024, real_assets=False,
                                          device=dev),
                 scenes.rain_config(1024)),
    }
    issue = {}

    def path_ms(path: str) -> float:
        make, cfg = setups[path]
        st = prepare_contacts(make(), cfg)
        k = cfg.contact_rebuild if anchored_path(st, cfg) else 1
        stepper = DeviceStepper(st, cfg) if replayed else None
        torch.cuda.synchronize()
        for i in range(steps):
            if i == window0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if stepper is not None:
                stepper.step()
                continue
            kind = "refresh" if st.step_count_host % k else "rebuild"
            ts = time.perf_counter()
            st, _ = step_with_metrics(st, cfg)
            if i >= window0:
                issue.setdefault(path, {}).setdefault(kind, []).append(
                    1e3 * (time.perf_counter() - ts))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (steps - window0)

    t0 = time.perf_counter()
    for path in paths:
        path_ms(path)               # builds the kernels; not reported
    first_s = time.perf_counter() - t0
    issue.clear()
    out = {"root": root, "first_scenes_s": first_s,
           "ms_per_step": {p: [path_ms(p) for _ in range(reps)]
                           for p in paths}}
    # host time to issue one step (no synchronize inside), median per
    # branch over the timed windows
    out["issue_ms_median"] = {p: {k: sorted(v)[len(v) // 2]
                                  for k, v in kinds.items()}
                              for p, kinds in issue.items()}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        make, cfg = setups[paths[0]]
        st = prepare_contacts(make(), cfg)
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(8):
                st, _ = step_with_metrics(st, cfg)
            torch.cuda.synchronize()
        out["ms_per_step_after_profile"] = [path_ms(paths[0])
                                            for _ in range(reps)]
    if cprofile:
        import cProfile
        import io
        import pstats

        make, cfg = setups[paths[0]]
        st = prepare_contacts(make(), cfg)
        pr = cProfile.Profile()
        pr.enable()
        for _ in range(40):
            st, _ = step_with_metrics(st, cfg)
        torch.cuda.synchronize()
        pr.disable()
        text = io.StringIO()
        pstats.Stats(pr, stream=text).sort_stats("tottime").print_stats(25)
        print(text.getvalue(), file=sys.stderr)
    return out


def compare(old: str, new: str, paths, rounds: int, reps: int,
            profile: bool, cprofile: bool, replayed: bool):
    gpu = card()
    print(gpu, flush=True)
    runs = {old: [], new: []}
    for _ in range(rounds):
        for root in (old, new, new, old):
            cmd = [sys.executable, __file__, "--worker", root, "--paths",
                   *paths, "--reps", str(reps)]
            if profile:
                cmd.append("--profile")
            if cprofile:
                cmd.append("--cprofile")
            if replayed:
                cmd.append("--replayed")
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=HERE)
            if res.returncode != 0:
                raise RuntimeError(f"worker {root} failed:\n{res.stdout}\n"
                                   f"{res.stderr[-4000:]}")
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            if cprofile:
                print(res.stderr, flush=True)
            runs[root].append(rec)
    summary = {}
    for root, recs in runs.items():
        summary[root] = {}
        for path in paths:
            ms = sorted(x for r in recs for x in r["ms_per_step"][path])
            per_process = [sorted(r["ms_per_step"][path])[reps // 2]
                           for r in recs]
            summary[root][path] = {"median_ms_per_step": ms[len(ms) // 2],
                                   "min": ms[0], "max": ms[-1], "n": len(ms),
                                   "process_medians": per_process}
        if profile:
            ap = sorted(x for r in recs
                        for x in r["ms_per_step_after_profile"])
            summary[root]["after_profile_median"] = ap[len(ap) // 2]
    print(json.dumps({"card": gpu, "summary": summary}), flush=True)


def build_times() -> None:
    sys.path.insert(0, str(HERE))
    from physics_tpu_torch import _build

    print(card(), flush=True)
    out_dir = _build.library_path()
    for so in out_dir.glob("*.so"):
        so.unlink()
    _, split_s, _ = _build.build()
    cus, _ = _build._sources()
    single = _build.BUILD_DIR / "single_probe.so"
    t0 = time.perf_counter()
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(single), *map(str, cus)], capture_output=True, text=True)
    single_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"single nvcc failed:\n{res.stdout}{res.stderr}")
    os.remove(single)
    print(json.dumps({"sources": [c.name for c in cus],
                      "one_nvcc_per_source_s": split_s,
                      "one_nvcc_over_all_s": single_s}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--worker")
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=["pile"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--replayed", action="store_true")
    ap.add_argument("--build-times", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.paths, args.reps,
                                args.profile, args.cprofile, args.replayed)))
    elif args.compare:
        compare(*args.compare, args.paths, args.rounds, args.reps,
                args.profile, args.cprofile, args.replayed)
    elif args.build_times:
        build_times()
    else:
        ap.error("pass --compare OLD NEW, or --build-times")
    return 0


if __name__ == "__main__":
    sys.exit(main())
