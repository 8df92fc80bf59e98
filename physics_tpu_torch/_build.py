"""Build and load the CUDA kernels (csrc/*.cu) as one shared library.

The sources have a plain C interface and are compiled with nvcc for
Hopper (sm_90a) into `_build/`, at first use, keyed by a hash of the
sources and flags; the library is loaded with ctypes. Every pointer and
the stream cross as c_void_p, every size as c_int. Nothing here runs
when the module is imported.

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
        _P, _P, _P, _P,            # geom, la, lb, prev cols (or NULL)
        _P, _P, _P,                # table, meta, warm (or NULL)
        _I, _I, _I, _I, _I, _I,    # nb, cap, cap2, ccap, kk, kg
        _I, _I,                    # npad, rows
        _F,                        # ground height
        _P,                        # stream
    ],
    "bs_banded_solve": [
        _P, _P, _P,                # table, warm8, geom
        _P, _P, _P,                # z out, lam out, posq out (or NULL)
        _P, _P,                    # scratch: consts [48, cp], z snapshot
        _I, _I, _I, _I,            # cp, npad, trows, n sweeps
        _I, _I,                    # vel iters, pos iters
        _F, _F, _F,                # baumgarte/dt, slop, relaxation
        _F, _I,                    # dt, flags
        _P,                        # stream
    ],
}

# bs_banded_solve flags
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
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libphysics_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is not built yet. Returns (path,
    seconds spent compiling, compiler output: ptxas's per-kernel report;
    empty when the library was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, cus)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, secs, res.stdout + res.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pk_error_string.argtypes = [_I]
    lib.pk_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (cudaGetLastError after
    its launches)."""
    if err != 0:
        msg = library().pk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
