"""Where the one-block-per-bucket box contact-table kernel spends its
time, by phase, on one NVIDIA card.

    python3 tools/table_split.py CHECKOUT

CHECKOUT is a checkout of the repository whose csrc/contact_table.cu still
has `contact_table_kernel` (one block per bucket running the in-kernel
broad phase, the prefilter, the manifolds, the ground corners, the stable
scan, the row writer, the meta counters and the warm match in turn, or a
passed-through bucket's copy and warm match), e.g. an earlier commit
unpacked with `git archive`. The script copies that checkout's package
into its git-ignored build directory, inserts a block-wide
`__syncthreads()` and a `clock64()` stamp by thread 0 at each phase,
builds it, and calls the kernel 5 times in each case:

  pile candidates   box_pile(4096, x_aspect=16) under pile_config(4096)
                    with contact_iters 8, settled 60 steps: the sweep's
                    candidate lanes (the table pile's rebuild);
  packed rebuild    packed_envs(4096, 8) under packed_env_config, settled
                    60 steps: the in-kernel same-env broad phase;
  packed all fired  the same, gated over the persisted table, every
                    bucket fired;
  packed none fired the same, no bucket fired (copy and warm match only).

It prints one JSON line: the card, and per case the kernel's device time
per launch (torch.profiler, with the stamps in) and per phase the mean
and largest block's cycles and its mean share of a block's cycles, which
splits that device time (each stamp's barrier costs a few cycles).
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

PHASES = ("broad phase (0)", "prefilter (1)", "manifolds (2)",
          "ground (3)", "scan (4)", "rows", "meta", "gate copy",
          "warm match (5)")
MAX_BLOCKS = 512
STAMP = ("{ind}__syncthreads();\n"
         "{ind}if (threadIdx.x == 0) g_ct_clk[blockIdx.x][{k}] = clock64();\n")
HEADER = ("#include \"boxbox.cuh\"\n\n"
          f"__device__ long long g_ct_clk[{MAX_BLOCKS}][10];\n"
          'extern "C" int ct_split_clocks(long long* out) {\n'
          "  return (int)cudaMemcpyFromSymbol(out, g_ct_clk, "
          "sizeof(g_ct_clk));\n}\n")
# (text in contact_table_kernel, the stamps to insert before it)
MARKS = (
    ("  if (tid == 0) *s.n_prev = 0;\n", None),   # stamp 0 after this line
    ("    // ---- phase 1: prefilter", (1,)),
    ("    // ---- phase 2: manifolds", (2,)),
    ("    // ---- phase 3: ground corners", (3,)),
    ("    // ---- phase 4: stable compaction", (4,)),
    ("    for (int e = tid; e < e_tot; e += blockDim.x) {\n"
     "      const int word = s.slot[e];", (5,)),
    ("    // ---- meta: dropped, active", (6,)),
    ("  }\n  if (!has_warm) return;", (7, 8)),
)
# a passed-through bucket: phases 0 to meta take no time, then its copy
GATE_OPEN = "    // ---- passed through: the persisted block, zero meta ----\n"
GATE_FILL = ("    if (threadIdx.x == 0)\n"
             "      for (int k = 1; k < 8; ++k) g_ct_clk[blockIdx.x][k] = "
             "g_ct_clk[blockIdx.x][0];\n")
GATE_END = ("      meta[(size_t)(i / kBlock) * d.nb * kBlock + (size_t)b * "
            "kBlock + i % kBlock] = 0.f;\n  } else {\n")
END = ("    for (int k = 3; k < 8; ++k) wout[(size_t)k * cp + j] = 0.f;\n"
       "  }\n}\n")


def stamps(ks, ind="    ") -> str:
    return "".join(STAMP.format(ind=ind, k=k) for k in ks)


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"mark not found once in contact_table.cu: {old!r}")
    return src.replace(old, new)


def instrument(src: str) -> str:
    if "contact_table_kernel" not in src:
        raise SystemExit("this checkout's box table has no "
                         "contact_table_kernel to split")
    src = replace_once(src, '#include "boxbox.cuh"\n', HEADER)
    for mark, ks in MARKS:
        if ks is None:
            src = replace_once(src, mark, mark + stamps((0,), "  "))
        else:
            src = replace_once(src, mark, stamps(ks) + mark)
    src = replace_once(src, "  if (!has_warm) return;",
                       "  if (!has_warm) {\n" + stamps((9,)) + "    return;\n"
                       "  }")
    src = replace_once(src, GATE_OPEN, GATE_OPEN + GATE_FILL)
    src = replace_once(src, GATE_END, GATE_END.replace(
        "  } else {\n", stamps((8,)) + "  } else {\n"))
    return replace_once(src, END, END[:-2] + stamps((9,), "  ") + "}\n")


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    copy = root / "physics_tpu_torch" / "_build" / "table_split"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(root / "physics_tpu_torch", copy / "physics_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = copy / "physics_tpu_torch" / "csrc" / "contact_table.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(copy))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from physics_tpu_torch import _build, scenes
    from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
    from physics_tpu_torch.ops import contact_table as ct
    from physics_tpu_torch.ops.broadphase import (
        body_aabbs,
        pair_candidates,
        sweep_order,
    )

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.build()
    lib = ctypes.CDLL(str(_build.library_path() / "contact_table.so"))

    def settled(state, cfg):
        st = prepare_contacts(state, cfg)
        for _ in range(60):
            st, _ = step_with_metrics(st, cfg)
        torch.cuda.synchronize()
        return st

    cases = {}
    cfg = scenes.pile_config(4096).replace(contact_iters=8)
    st = settled(scenes.box_pile(4096, x_aspect=16.0, device=dev), cfg)
    aabbs = body_aabbs(st)
    order = sweep_order(st, aabbs)
    cand = pair_candidates(st, cfg, aabbs, order)
    geom = ct.unified_geom(st, cfg, order)
    prev = (st.contact_key, st.contact_lam)
    cases["pile candidates"] = lambda: ct.bucket_contact_table(
        st, cand, cfg, prev=prev, geom=geom)
    pcfg = scenes.packed_env_config(4096, 8)
    sp = settled(scenes.packed_envs(4096, 8, device=dev), pcfg)
    pgeom = ct.unified_geom(sp, pcfg, None)
    pprev = (sp.contact_key, sp.contact_lam)
    nbp = ct.table_shape(sp.num_bodies, pcfg)[0]
    every = torch.arange(nbp, device=dev)
    for name, gate in (("packed rebuild", None),
                       ("packed all fired", every >= 0),
                       ("packed none fired", every < 0)):
        g = None if gate is None else (gate, sp.contact_table)
        cases[name] = (lambda g=g: ct.bucket_contact_table(
            sp, None, pcfg, prev=pprev, geom=pgeom, gate=g))

    out = {"card": gpu, "cases": {}}
    for name, call in cases.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and "contact_table_kernel" in e.key]
        us = ev[0].self_device_time_total / ev[0].count if ev else None
        nb = call()[1].shape[1] // 128
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (MAX_BLOCKS * 10))()
        err = lib.ct_split_clocks(buf)
        if err:
            raise RuntimeError(f"reading the stamps: CUDA error {err}")
        clk = torch.tensor(list(buf), dtype=torch.float64).reshape(
            MAX_BLOCKS, 10)[:nb]
        cyc = clk[:, 1:] - clk[:, :-1]                     # [nb, 9]
        total = cyc.sum(dim=1, keepdim=True)
        share = (cyc / total).mean(dim=0)
        out["cases"][name] = {
            "buckets": nb, "device_us_per_launch": us,
            "block_cycles_mean": float(total.mean()),
            "block_cycles_max": float(total.max()),
            "phases": {p: {"mean_cycles": float(cyc[:, k].mean()),
                           "max_cycles": float(cyc[:, k].max()),
                           "share": float(share[k]),
                           "us": float(share[k]) * us if us else None}
                       for k, p in enumerate(PHASES)}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
