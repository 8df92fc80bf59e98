"""The joint solve's conjugate gradient (physics_tpu/solver/cg.py `solve`)
on the matrix-free operator J·W·Jᵀ of the joint rows.

As the reference runs it: the warm start x0; convergence tested after
the x update, ‖r‖∞ < max(‖rhs‖∞·rel_tol, abs_tol); at most max_iters
iterations; α = r·r / p·Ap guarded against a zero denominator (0, as
the JAX package and the NumPy oracle guard it) and β against a zero
r·r. Returns (x, converged, iterations) as device tensors; the caller
applies no force and keeps the stale warm start where it did not
converge (quirk Q7, engine.solve_joints).

`solve` is the kernel wrapper: on a CUDA tensor it launches
csrc/joint_cg.cu, the whole loop in one cooperative launch that reads
nothing back; on a CPU tensor (or with plain=True) it runs
`solve_plain`, a host loop with the same formulas and the same sums: a
dot product sums each slot's three rows (r₀ + r₁) + r₂, then adjacent
pairs level by level over the slots padded with zeros to a power of two
(`slot_dot`), which is the kernel's order.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from physics_tpu_torch.solver.joints import JointRows, operator

Tensor = torch.Tensor


def tree_sum(v: Tensor) -> Tensor:
    """Σ v by adjacent pairs, level by level, over v padded with zeros to
    a power of two."""
    m = v.shape[0]
    p = 1
    while p < m:
        p *= 2
    v = torch.nn.functional.pad(v, (0, p - m))
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def slot_dot(a: Tensor, b: Tensor) -> Tensor:
    """a·b in the kernel's order: (a₀b₀ + a₁b₁) + a₂b₂ a slot of three
    rows (the last slot padded with zeros), then tree_sum over the
    slots."""
    v = a * b
    v = torch.nn.functional.pad(v, (0, -v.shape[0] % 3)).reshape(-1, 3)
    return tree_sum((v[:, 0] + v[:, 1]) + v[:, 2])


def solve_plain(op: Callable[[Tensor], Tensor], rhs: Tensor, x0: Tensor,
                max_iters: int = 1000, rel_tol: float = 1e-2,
                abs_tol: float = 1e-3) -> Tuple[Tensor, Tensor, Tensor]:
    """CG on A·x = rhs with A = `op`, a host loop (it reads the stop back
    each iteration). Returns (x, converged bool [], iterations int32 [])."""
    rhs = rhs.to(torch.float32)
    # max(‖rhs‖∞·rel, abs), the config's numbers rounded to f32
    threshold = torch.clamp(torch.amax(torch.abs(rhs)) * rel_tol,
                            min=abs_tol)
    x = x0
    r = rhs - op(x0)
    p = r
    rk = slot_dot(r, r)
    zero = torch.zeros((), dtype=torch.float32, device=rhs.device)
    iters, converged = 0, False
    while iters < max_iters:
        ap = op(p)
        den = slot_dot(p, ap)
        alpha = torch.where(den != 0.0, rk / den, zero)
        x = x + alpha * p
        r = r - alpha * ap
        amax = torch.amax(torch.abs(r))
        rk_new = slot_dot(r, r)
        beta = torch.where(rk != 0.0, rk_new / rk, zero)
        p = r + beta * p
        iters += 1
        converged = bool(amax < threshold)
        if converged:
            break
        rk = rk_new
    return (x, torch.tensor(converged, device=rhs.device),
            torch.tensor(iters, dtype=torch.int32, device=rhs.device))


def plan(nj: int, dev) -> Dict[str, int]:
    """The kernel's launch for nj slots on CUDA device `dev`."""
    from physics_tpu_torch import _build

    out = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        err = _build.library().jcg_plan(nj, ctypes.cast(out,
                                                        ctypes.c_void_p))
    _build.check(err, "jcg_plan")
    return dict(zip(("slots_a_thread", "grid", "blocks_an_sm",
                     "registers"), out))


def solve(rows: JointRows, w: Tensor, rhs: Tensor, x0: Tensor, *,
          max_iters: int, rel_tol: float, abs_tol: float,
          plain: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """CG on the operator J·W·Jᵀ of `rows` (W: w [N, 10], see
    joints.apply_w) from the warm start x0 [J·3]. A CPU tensor (or
    plain=True) runs solve_plain; a CUDA tensor launches
    csrc/joint_cg.cu once."""
    n = w.shape[0]
    kw = dict(max_iters=max_iters, rel_tol=rel_tol, abs_tol=abs_tol)
    if plain or rhs.device.type == "cpu":
        return solve_plain(operator(rows, w, n), rhs, x0, **kw)
    if rhs.device.type != "cuda":
        raise ValueError(f"joint CG: unsupported device {rhs.device}")
    return _launch(rows, w, rhs, x0, **kw)


solve.launches = 0

# partial sums a block: p·Ap, ‖r‖∞ and r·r; room for the kernel's 1,024
_PART = 3 * 1024


def _launch(rows, w, rhs, x0, *, max_iters, rel_tol, abs_tol):
    from physics_tpu_torch import _build

    dev = rhs.device
    jn = rows.j_a.shape[0]
    n = w.shape[0]
    f32, i32 = torch.float32, torch.int32
    ja, jb = rows.j_a.contiguous(), rows.j_b.contiguous()
    body_a, body_b = rows.body_a.to(i32), rows.body_b.to(i32)
    flags = ((rows.rowmask[:, 0] > 0).to(i32)
             | ((rows.has_b > 0).to(i32) * 2))
    x0 = x0.contiguous()
    _build.check_operands(
        "joint CG", dev,
        ("j_a", ja, f32, (jn, 3, 6)), ("j_b", jb, f32, (jn, 3, 6)),
        ("w", w, f32, (n, 10)), ("rhs", rhs, f32, (3 * jn,)),
        ("x0", x0, f32, (3 * jn,)))
    x = torch.empty((3 * jn,), dtype=f32, device=dev)
    status = torch.empty((2,), dtype=i32, device=dev)
    scratch = torch.empty((2 * n * 6 + _PART,), dtype=f32, device=dev)
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = _build.library().jcg_solve(
            ptr(ja.data_ptr()), ptr(jb.data_ptr()), ptr(body_a.data_ptr()),
            ptr(body_b.data_ptr()), ptr(flags.data_ptr()),
            ptr(w.data_ptr()), ptr(rhs.data_ptr()), ptr(x0.data_ptr()),
            ptr(x.data_ptr()), ptr(status.data_ptr()),
            ptr(scratch.data_ptr()), ptr(scratch[2 * n * 6:].data_ptr()),
            _PART, jn, n, max_iters, ctypes.c_float(rel_tol),
            ctypes.c_float(abs_tol),
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "jcg_solve")
    solve.launches += 1
    return x, status[1] != 0, status[0]
