"""Where the one-block-per-bucket emit kernel of the hull contact table
spends its time, by section, on one NVIDIA card.

    python3 tools/hull_emit_split.py CHECKOUT

CHECKOUT is a checkout of the repository whose csrc/hull_table.cu still
has `hull_emit_kernel` (one block per bucket doing the ground vertices,
the stable scan, the table rows, the meta counters and the warm match in
turn), e.g. an earlier commit unpacked with `git archive`. The script
copies that checkout's package into its git-ignored build directory,
inserts a block-wide `__syncthreads()` and a `clock64()` stamp by thread
0 before each section and at the end of the kernel, builds it, settles
`mesh_rain(1024)` under `rain_config(1024)` for 60 steps and calls the
table kernel 5 times. It prints one JSON line: the card, the kernel's
device time per launch (torch.profiler), and per section the mean and
largest block's cycles and its share of the block's total, which
splits that device time (the stamps' barriers cost a few cycles each).
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

SECTIONS = ("ground", "scan", "rows", "meta", "warm")
# the first line of each section in hull_emit_kernel, then its last line
MARKS = ("  // ---- ground: the kg lowest vertices",
         "  // ---- stable compaction of the emissions",
         "  float* out = table + (size_t)b * d.ccap;",
         "  // ---- meta: dropped, active, prefilter drops",
         "  // ---- warm start by key match within the bucket")
END = "    for (int k = 3; k < 8; ++k) wout[(size_t)k * cp + j] = 0.f;\n  }\n"
STAMP = ("  __syncthreads();\n"
         "  if (threadIdx.x == 0) g_emit_clk[blockIdx.x][{k}] = clock64();\n")
HEADER = ('#include "common.cuh"\n\n'
          "__device__ long long g_emit_clk[256][6];\n"
          'extern "C" int ht_emit_clocks(long long* out) {\n'
          "  return (int)cudaMemcpyFromSymbol(out, g_emit_clk, "
          "sizeof(g_emit_clk));\n}\n")


def instrument(src: str) -> str:
    if "hull_emit_kernel" not in src:
        raise SystemExit("this checkout's hull table has no "
                         "hull_emit_kernel to split")
    src = src.replace('#include "common.cuh"\n', HEADER, 1)
    for k, mark in enumerate(MARKS):
        if src.count(mark) != 1:
            raise SystemExit(f"section mark not found once: {mark!r}")
        src = src.replace(mark, STAMP.format(k=k) + mark)
    if src.count(END) != 1:
        raise SystemExit("the emit kernel's end was not found")
    return src.replace(END, END + STAMP.format(k=len(MARKS)))


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    copy = root / "physics_tpu_torch" / "_build" / "emit_split"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(root / "physics_tpu_torch", copy / "physics_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = copy / "physics_tpu_torch" / "csrc" / "hull_table.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(copy))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from physics_tpu_torch import _build, scenes
    from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
    from physics_tpu_torch.ops import hull_table as ht
    from physics_tpu_torch.ops.broadphase import (
        body_aabbs,
        pair_candidates,
        sweep_order,
    )
    from physics_tpu_torch.ops.contact_table import unified_geom

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = scenes.rain_config(1024)
    st = prepare_contacts(scenes.mesh_rain(1024, real_assets=False,
                                           device=dev), cfg)
    for _ in range(60):
        st, _ = step_with_metrics(st, cfg)
    aabbs = body_aabbs(st)
    order = sweep_order(st, aabbs)
    cand = pair_candidates(st, cfg, aabbs, order)
    geom = unified_geom(st, cfg, order, hulls=True)
    prev = (st.contact_key, st.contact_lam)

    def call():
        return ht.bucket_hull_contact_table(st, cand, cfg, prev=prev,
                                            geom=geom)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    emit = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "hull_emit_kernel" in e.key]
    emit_us = emit[0].self_device_time_total / emit[0].count if emit else None
    nb = -(-st.num_bodies // 128)
    lib = ctypes.CDLL(str(_build.library_path() / "hull_table.so"))
    buf = (ctypes.c_longlong * (256 * 6))()
    err = lib.ht_emit_clocks(buf)
    if err:
        raise RuntimeError(f"reading the stamps: CUDA error {err}")
    stamps = torch.tensor(list(buf), dtype=torch.float64).reshape(256, 6)[:nb]
    cyc = stamps[:, 1:] - stamps[:, :-1]              # [nb, 5]
    total = cyc.sum(dim=1, keepdim=True)
    share = (cyc / total).mean(dim=0)
    print(json.dumps({
        "card": gpu, "buckets": nb, "emit_us_per_launch": emit_us,
        "sections": {name: {"mean_cycles": float(cyc[:, k].mean()),
                            "max_cycles": float(cyc[:, k].max()),
                            "share": float(share[k]),
                            "us": (float(share[k]) * emit_us
                                   if emit_us else None)}
                     for k, name in enumerate(SECTIONS)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
