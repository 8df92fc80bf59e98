"""Run one cell of the benchmark of physics_tpu_torch once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. Earlier
lines of standard output are diagnostics; the last is one JSON object
(correct, attempted, failed, metrics, device, with --trace 1 breakdown,
and last the compared numbers with their limits, which also end
standard error). Without a card, or with fewer than the cell asks for,
it exits 2 and prints no result; if jax, jaxlib, flax or physics_tpu is
loaded once the window has closed, it exits 3."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    t_torch = time.perf_counter()
    from portbench.core import spec as spec_mod

    spec = spec_mod.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < (
            spec.chips):
        print(f"portbench: {args.workload} needs {spec.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the port's CUDA kernels build inside the checkout
    # (physics_tpu_torch/_build); nothing else here keeps a cache
    os.environ.setdefault("USE_FLAX", "0")

    from portbench.core import bench, smi

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros((1,), device=dev)
    bench.log(f"set-up s: import torch {t_torch - T0:.3f}; the harness and "
              f"the card's context {time.perf_counter() - t_torch:.3f}")
    out = bench.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                         dev, T0)
    bench.log(f"card: {smi.card_line()}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}")
    bad = bench.loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad} in the process that measures",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = out.per_layer
        units = {m["name"]: m["unit"] for m in spec.per_layer}
    else:
        metrics = out.metrics
        units = {m["name"]: m["unit"] for m in spec.end_to_end}
    checks = {k: {"value": out.numbers[k], "limit": out.limits[k]}
              for k in out.limits}
    result = {
        "correct": bool(out.correct),
        "attempted": out.attempted,
        "failed": 0 if out.correct else 1,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in metrics.items() if k in units},
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(dev),
                   "count": 1,
                   "memory_peak_bytes": int(out.memory_peak_bytes)},
    }
    if args.trace:
        result["device"]["busy_s"] = out.trace.busy_us * 1e-6
        result["device"]["window_s"] = out.trace.window_us * 1e-6
        result["breakdown"] = out.breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
