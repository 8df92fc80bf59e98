"""The `table` stage of a gated refresh on the packed envs, function by
function: device operations and device µs of each piece, for a checkout
of this repo (its own physics_tpu_torch), on one NVIDIA card.

    python3 tools/table_census.py [CHECKOUT]     # default: this checkout

`scenes.packed_envs(4096, 8)` under `packed_env_config(4096, 8)` (the
benchmark's `envs4096x8`), settled 40 steps. Then each function that runs
after `tracing.stage("table")` on a gated refresh, called alone on that
state: `refresh_gate`, the gate's int32 cast, `prev_key_cols`, the
contact table's own launches (2.2), `_overflow` with the maximum, the
`contact_ref` tail (repeat_interleave, cat, where), and the whole
`_gated_refresh`; where the checkout has them, `refresh_prep` (in place
of the first three and the tail) and `table_prep` without a gate (the
columns alone, as a rebuild builds them). Each piece is profiled over 10
calls (torch.profiler: every kernel, copy and memset it puts on the
card, by name), and timed as a CUDA graph of 20 calls replayed 10 times
(CUDA events), which is how the step runs it. One JSON line per piece,
with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from physics_tpu_torch import scenes
    from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
    from physics_tpu_torch.ops import contact_table as ct
    from physics_tpu_torch.solver import contacts as tc

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def profiled(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_op = {}
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                row = by_op.setdefault(e.key[:60], [0.0, 0.0])
                row[0] += e.count / reps
                row[1] += e.self_device_time_total / reps
        return {"device_ops": sum(r[0] for r in by_op.values()),
                "device_us": round(sum(r[1] for r in by_op.values()), 2),
                "by_op": {k: [r[0], round(r[1], 2)]
                          for k, r in by_op.items()}}

    def replayed_us(fn, calls=20, reps=10):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) * 1e3 / calls)
        times.sort()
        return round(times[len(times) // 2], 2)

    def emit(what, fn):
        print(json.dumps({"checkout": str(root), "what": what, "card": card,
                          "replayed_us": replayed_us(fn),
                          **profiled(fn)}), flush=True)

    cfg = scenes.packed_env_config(4096, 8)
    st = prepare_contacts(scenes.packed_envs(4096, 8, device=dev), cfg)
    for _ in range(40):
        st, _ = step_with_metrics(st, cfg)
    geom = ct.unified_geom(st, cfg, None)
    gate = tc.refresh_gate(st, cfg, None)
    prev = (st.contact_key, st.contact_lam)
    pcols = ct.prev_key_cols(*prev)
    gate32 = gate.to(torch.int32).contiguous()
    _, meta, _ = ct.bucket_contact_table(st, None, cfg, prev=prev, geom=geom,
                                         gate=(gate, st.contact_table))
    print(json.dumps({"checkout": str(root), "card": card,
                      "gate_fired": int(gate.sum()),
                      "gate_buckets": gate.numel(),
                      "slots": pcols.shape[0]}), flush=True)
    n = st.num_bodies

    def tail():
        fired = gate.repeat_interleave(ct.BLOCK)[:n]
        return torch.where(fired[:, None], torch.cat([st.pos, st.quat], 1),
                           st.contact_ref)

    la, lb, _, kw = ct.table_operands(st, None, cfg, None, geom, "census")
    kw["kk"] = min(cfg.max_contacts_per_pair, ct._CAP)
    kw["kg"] = min(cfg.max_contacts_per_pair, 8) if cfg.ground_plane else 0
    kw["gate"] = (gate32, st.contact_table)
    pieces = {
        "refresh_gate": lambda: tc.refresh_gate(st, cfg, None),
        "gate cast": lambda: gate.to(torch.int32).contiguous(),
        "prev_key_cols": lambda: ct.prev_key_cols(*prev),
        "2.2 launches alone": lambda: ct._launch_kernel(geom, la, lb, pcols,
                                                        **kw),
        "_overflow and maximum": lambda: torch.maximum(
            st.contact_meta, tc._overflow(meta, None)),
        "contact_ref tail": tail,
        "_gated_refresh, whole": lambda: tc._gated_refresh(st, cfg, None,
                                                           geom, False),
    }
    if hasattr(tc, "refresh_prep"):
        pieces["refresh_prep"] = lambda: tc.refresh_prep(st, cfg, None)
        pieces["table_prep, columns only"] = lambda: ct.table_prep(*prev)
    for what, fn in pieces.items():
        emit(what, fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
