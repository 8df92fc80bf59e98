"""Build and load the CUDA kernels (csrc/*.cu).

Each source has a plain C interface and is compiled with nvcc for Hopper
(sm_90a) into its own shared library under `_build/<hash>/`, at first
use; the hash covers every source, header and flag. All the nvcc
processes start together, so the build takes as long as the slowest
file. The libraries are loaded with ctypes: every pointer and the stream
cross as c_void_p, every size as c_int. Nothing here runs when the module
is imported.

`-fmad=false` keeps every multiply and add separately rounded, as
PyTorch's elementwise operators round them, so a kernel that computes
the same operations in the same order as its plain version gives the
same bits (and the same contact decisions).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",        # registers, shared memory and spills per kernel
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points: name → argument types (restype is int, a cudaError_t)
SIGNATURES = {
    "ct_bucket_contact_table": [
        _P, _P, _P, _P,            # geom, la, lb (or NULL), prev cols (or NULL)
        _P, _P,                    # gate, persisted table (or NULL)
        _P, _P, _P,                # table, meta, warm (or NULL)
        _P, _I,                    # int32 scratch and its words
        _I, _I, _I, _I, _I, _I, _I,  # nb, bucket0, cap, cap2, ccap, kk, kg
        _I, _I, _I, _I,            # npad, rows, bp_k, env_k
        _F,                        # ground height
        _P,                        # stream
    ],
    # the box table's scratch words: nb, cap, cap2, kk, kg, ccap
    "ct_scratch_words": [_I, _I, _I, _I, _I, _I],
    "ht_bucket_hull_contact_table": [
        _P, _P, _P, _P,            # geom, la, lb, prev cols (or NULL)
        _P, _P, _P, _P, _P,        # c16, c32, c88, c80, cb
        _P, _P, _P,                # edge indices, ground verts, vertex bias
        _P, _P, _P,                # table, meta, warm (or NULL)
        _P, _I,                    # int32 scratch and its words
        _I, _I, _I, _I, _I, _I, _I,  # nb, bucket0, cap, cap2, ccap, kk, kg
        _I, _I, _I,                # npad, rows, hull types
        _I, _I, _I, _I, _I, _I,    # fp, vcap, e, d2, d2p, e2p
        _I, _I, _I,                # rows of c16, c32, cb per type pair
        _F,                        # ground height
        _P,                        # stream
    ],
    # the hull table's scratch words: nb, SAT lanes, kk, kg, ccap, fp, d2
    "ht_scratch_words": [_I, _I, _I, _I, _I, _I, _I],
    "bs_banded_solve": [
        _P, _P, _P,                # table, warm8, geom
        _P, _P, _P,                # z out, lam out, posq out (or NULL)
        _P, _P, _P, _P,            # scratch: consts [48, cp], z tables,
                                   # global state [9, cp], live list
        _I,                        # live list length
        _I, _I, _I, _I,            # cp, npad, trows, n sweeps
        _I, _I,                    # vel iters, pos iters
        _F, _F, _F,                # baumgarte/dt, slop, relaxation
        _F, _I,                    # dt, flags
        _P,                        # stream
    ],
    "bs_banded_sweeps": [
        _P, _P, _P, _P,            # z0, bases, la, lb
        _P, _P,                    # geom, cin
        _P, _P,                    # consts scratch, consts out (or NULL)
        _P,                        # posq (or NULL)
        _P, _P, _P,                # z out, lam out, posq out (or NULL)
        _P, _P, _P,                # scratch: z tables, global state, list
        _I,                        # live list length
        _I, _I, _I, _I,            # cp, npad, tile, n sweeps
        _I, _I,                    # vel iters, pos iters
        _F, _F, _F,                # baumgarte/dt, slop, relaxation
        _F, _I,                    # dt, flags
        _P,                        # stream
    ],
    # the persistent solve's grid and its kernel's resources
    "bs_solve_plan": [_I, _I, _P],   # fused, cp, int32 [7] out
    "bs_sharded_sweep": [
        _P, _P, _P, _P,            # z0, bases, la, lb
        _P, _P, _I,                # geom, cin, cin's row stride
        _P, _P,                    # consts scratch, consts out (or NULL)
        _P, _P, _P, _P, _P, _P, _P,  # scratch: λ, z tables, delta tables,
                                     # live list, its length, endpoint
                                     # ranks, relaxations
        _I, _I, _I, _I,            # cp, npad, tile, sweep
        _F, _F,                    # vel on, pos on
        _F, _F, _F,                # baumgarte/dt, slop, relaxation
        _I,                        # warm
        _P,                        # stream
    ],
    "sw_window_masks": [
        _P, _P, _P, _P,            # sorted AABBs, flags; mask, last out
        _I, _I,                    # n, window
        _P,                        # stream
    ],
    "sw_bucketed_candidates": [
        _P, _P, _P,                # order, AABBs, shape types
        _P, _P, _P, _P, _P, _P,    # body a/b, mask, rank a/b, overflow out
        _I, _I, _I, _I,            # n, window, block, cap
        _P,                        # stream
    ],
    "jcg_solve": [
        _P, _P, _P, _P, _P,        # j_a, j_b, body a, body b, slot flags
        _P, _P, _P,                # W blocks, rhs, warm start
        _P, _P,                    # x out, status out (iterations, stop)
        _P, _P, _I,                # body tables, partials and their floats
        _I, _I, _I,                # slots, bodies, max iterations
        _F, _F,                    # rel_tol, abs_tol
        _P,                        # stream
    ],
    # the CG's launch: slots a thread, blocks, blocks an SM, registers
    "jcg_plan": [_I, _P],
    # one graph of a predicate's graph and two sides behind conditional
    # nodes (csrc/graph_cond.cu): the three raw graphs, the int32 flag,
    # [2] out (instance, graph)
    "gc_compose": [_P, _P, _P, _P, _P],
    "gc_launch": [_P, _P],             # instance, stream
    "gc_destroy": [_P, _P],            # instance, graph
    "np_banded_contacts": [
        _P, _P, _P, _P,            # pos, quat, box params, inverse mass
        _P, _P, _P, _P,            # shape type, friction, restitution, rank
        _P, _P,                    # geom, static tile bases (or NULL)
        _P, _P, _P, _P, _P,        # candidates: mask, rank a/b, body a/b
        _P, _P, _P,                # f32 [9, C], int32 [5, C], active [C]
        _I, _I, _I, _I,            # n, kg, first ground slot, ground slots
        _F,                        # ground height
        _I, _I, _I,                # lanes: all, first, this rank's
        _I, _I, _I, _I, _I,        # tile, npad, window, kk, flags
        _P,                        # stream
    ],
}

# bs_banded_solve / bs_banded_sweeps flags
FLAG_USE_SPLIT = 1
FLAG_ANCHORED = 2
FLAG_INTEGRATE = 4
FLAG_RENORM = 8


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """The directory that holds one built library per source."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"kernels_{h.hexdigest()[:16]}"


def build() -> tuple[Path, float, str]:
    """Compile every source not built yet, all nvcc processes at once.
    Returns (library directory, seconds spent compiling, compiler output:
    ptxas's per-kernel report; empty when everything was built)."""
    out_dir = library_path()
    cus, _ = _sources()
    todo = [cu for cu in cus if not (out_dir / f"{cu.stem}.so").exists()]
    if not todo:
        return out_dir, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for cu in todo:
        tmp = out_dir / f"{cu.stem}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(cu)]
        procs.append((cu, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = [], []
    for cu, tmp, cmd, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {cu.name}:\n"
                          f"{' '.join(cmd)}\n{text}")
            continue
        os.replace(tmp, out_dir / f"{cu.stem}.so")
        reports.append(f"== {cu.name}\n{text}")
    secs = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return out_dir, secs, "\n".join(reports)


@functools.cache
def library() -> SimpleNamespace:
    """Every C entry point of the built libraries (built on first use),
    as attributes of one namespace."""
    out_dir, _, _ = build()
    ns = SimpleNamespace()
    for so in sorted(out_dir.glob("*.so")):
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is None:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(ns, name, fn)
        fn = getattr(lib, "pk_error_string", None)
        if fn is not None:
            fn.argtypes = [_I]
            fn.restype = ctypes.c_char_p
            ns.pk_error_string = fn
    missing = [n for n in [*SIGNATURES, "pk_error_string"]
               if not hasattr(ns, n)]
    if missing:
        raise RuntimeError(f"kernel libraries lack {missing}")
    return ns


def check_operands(what: str, dev, *named) -> None:
    """Raise unless each (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on `dev`: what a C entry point
    takes."""
    for name, t, dt, shape in named:
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"{list(shape)} tensor on {dev}")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (cudaGetLastError after
    its launches)."""
    if err != 0:
        msg = library().pk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
