"""The readings that a cell's correctness limits are set from, on the
card: for each of `--seeds` a run of the cell (set-up, a window of
`--seconds`, the comparison with the reference), and for each of
`--control-seeds` also the control (the reference with its state held
in bfloat16, judged by the f32 reference), all in one process; then for
each of `--stall-seeds` a run whose steps leave the state unchanged
once set-up's calls are done (a fault in the window only):

    python3 portbench/calibrate.py --workload <name> --seconds 2
        --seeds 1 2 3 ... --control-seeds 1 2 3 [--stall-seeds 4 5 6]
        [--out <file.jsonl>]

One JSON line a run (on standard output and in --out): the compared
numbers, the control's, and the run's end-to-end metrics."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--stall-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench.core import bench
    from portbench.core import spec as spec_mod

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    spec = spec_mod.load(args.workload)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    sound = spec.call

    class Stalled(sound):
        def call(self, k, after_step=None):
            if k >= self.schedule.settle_calls:
                self.stepper.step = lambda: self.stepper.state
            super().call(k, after_step)

    runs = [(s, "sound") for s in args.seeds] + [
        (s, "stall") for s in args.stall_seeds]
    try:
        for seed, kind in runs:
            spec.call = sound if kind == "sound" else Stalled
            t0 = time.perf_counter()
            r = bench.run_cell(spec, seed, args.seconds, False, dev, t0,
                               control=(kind == "sound"
                                        and seed in args.control_seeds))
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "run": kind, "correct": r.correct,
                               "numbers": r.numbers, "metrics": r.metrics,
                               "capture_ms": r.capture_ms,
                               "memory_peak_bytes": r.memory_peak_bytes})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
