"""Sweep-window masks: Triton kernel and its plain PyTorch version.

Replaces the TPU kernel `sweep_window_masks` (physics_tpu/ops/
sweep_pallas.py:61, body `_window_mask_kernel` :34-57), which kept the
sorted AABBs in VMEM and unrolled the window loop over lane-shifted
slices.

What it computes, for AABBs sorted by min-x and each rank i and offset
d = 1..k: mask[i, d-1] = rank i+d exists, its min-x starts before i's
max-x, the two boxes overlap on all three axes, and both are collidable;
last[i] = rank i is collidable and rank i+k still x-overlaps it (the
window may be too short). These are the semantics of the JAX package's
XLA branch (physics_tpu/ops/broadphase.py:136-162), which is what that
package runs off the TPU and what the tests hold this port to.

On the H100: the work is 7 compares per (i, d), about 200k pairs at the
4k pile, so the kernel is bound by launch latency and by writing the
[N, k] byte mask (0.2 MB). One program handles a [64, 64] tile of
(rank, offset); the neighbour reads stay within 48 ranks of the tile, so
L1/L2 serve them; nothing but the mask and the last-overlap flags is
written.
"""

from __future__ import annotations

import functools
import os

import torch

Tensor = torch.Tensor

_BLOCK_N = 64


def sweep_window_masks_plain(aabb_sorted: Tensor, coll_sorted: Tensor,
                             k: int):
    """Plain version: k shifted slices of the +inf-padded sorted AABBs."""
    n = aabb_sorted.shape[0]
    dev = aabb_sorted.device
    pad_aabb = torch.cat([aabb_sorted, torch.full(
        (k, 2, 3), float("inf"), dtype=aabb_sorted.dtype, device=dev)])
    pad_coll = torch.cat([coll_sorted,
                          torch.zeros((k,), dtype=torch.bool, device=dev)])
    nb_aabb = torch.stack([pad_aabb[d:d + n] for d in range(1, k + 1)],
                          dim=1)                             # [N,k,2,3]
    nb_coll = torch.stack([pad_coll[d:d + n] for d in range(1, k + 1)],
                          dim=1)                             # [N,k]
    x_overlap = nb_aabb[:, :, 0, 0] <= aabb_sorted[:, None, 1, 0]
    lo = torch.maximum(aabb_sorted[:, None, 0, :], nb_aabb[:, :, 0, :])
    hi = torch.minimum(aabb_sorted[:, None, 1, :], nb_aabb[:, :, 1, :])
    full_overlap = torch.all(lo <= hi, dim=-1)
    valid = (torch.arange(n, device=dev)[:, None]
             + torch.arange(1, k + 1, device=dev)[None, :]) < n
    mask = (valid & x_overlap & full_overlap & coll_sorted[:, None]
            & nb_coll)
    last = x_overlap[:, -1] & valid[:, -1] & coll_sorted
    return mask, last


@functools.cache
def _triton_kernel():
    from physics_tpu_torch._build import BUILD_DIR

    # Triton's compile cache goes beside the CUDA library, inside the
    # checkout, unless the caller chose one
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def masks_kernel(aabb_ptr, coll_ptr, mask_ptr, last_ptr, n,
                     K: tl.constexpr, KP: tl.constexpr,
                     BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        in_i = i < n
        d = tl.arange(0, KP) + 1
        j = i[:, None] + d[None, :]
        in_d = d[None, :] <= K
        valid = in_i[:, None] & in_d & (j < n)
        inf = float("inf")
        c_lo_x = tl.load(aabb_ptr + i * 6 + 0, mask=in_i, other=inf)
        c_lo_y = tl.load(aabb_ptr + i * 6 + 1, mask=in_i, other=inf)
        c_lo_z = tl.load(aabb_ptr + i * 6 + 2, mask=in_i, other=inf)
        c_hi_x = tl.load(aabb_ptr + i * 6 + 3, mask=in_i, other=-inf)
        c_hi_y = tl.load(aabb_ptr + i * 6 + 4, mask=in_i, other=-inf)
        c_hi_z = tl.load(aabb_ptr + i * 6 + 5, mask=in_i, other=-inf)
        n_lo_x = tl.load(aabb_ptr + j * 6 + 0, mask=valid, other=inf)
        n_lo_y = tl.load(aabb_ptr + j * 6 + 1, mask=valid, other=inf)
        n_lo_z = tl.load(aabb_ptr + j * 6 + 2, mask=valid, other=inf)
        n_hi_x = tl.load(aabb_ptr + j * 6 + 3, mask=valid, other=inf)
        n_hi_y = tl.load(aabb_ptr + j * 6 + 4, mask=valid, other=inf)
        n_hi_z = tl.load(aabb_ptr + j * 6 + 5, mask=valid, other=inf)
        c_coll = tl.load(coll_ptr + i, mask=in_i, other=0) != 0
        n_coll = tl.load(coll_ptr + j, mask=valid, other=0) != 0

        x_ov = n_lo_x <= c_hi_x[:, None]
        full = ((tl.maximum(c_lo_x[:, None], n_lo_x)
                 <= tl.minimum(c_hi_x[:, None], n_hi_x))
                & (tl.maximum(c_lo_y[:, None], n_lo_y)
                   <= tl.minimum(c_hi_y[:, None], n_hi_y))
                & (tl.maximum(c_lo_z[:, None], n_lo_z)
                   <= tl.minimum(c_hi_z[:, None], n_hi_z)))
        hit = valid & x_ov & full & c_coll[:, None] & n_coll
        tl.store(mask_ptr + i[:, None] * K + (d[None, :] - 1),
                 hit.to(tl.uint8), mask=in_i[:, None] & in_d)

        jl = i + K
        vl = in_i & (jl < n)
        l_lo_x = tl.load(aabb_ptr + jl * 6, mask=vl, other=inf)
        last = vl & (l_lo_x <= c_hi_x) & c_coll
        tl.store(last_ptr + i, last.to(tl.uint8), mask=in_i)

    return masks_kernel


def sweep_window_masks(aabb_sorted: Tensor, coll_sorted: Tensor, k: int,
                       plain: bool = False):
    """(mask [N, k] bool, last [N] bool) for AABBs [N, 2, 3] f32 sorted by
    min-x and their collidable flags [N] bool, window k ≥ 1.

    A CPU tensor (or `plain=True`, used to hold the kernel against its
    plain version on the card) runs `sweep_window_masks_plain`; a CUDA
    tensor launches the Triton kernel."""
    n = aabb_sorted.shape[0]
    if aabb_sorted.shape != (n, 2, 3) or aabb_sorted.dtype != torch.float32:
        raise ValueError(f"aabb_sorted must be [N, 2, 3] f32, got "
                         f"{tuple(aabb_sorted.shape)} {aabb_sorted.dtype}")
    if coll_sorted.shape != (n,) or coll_sorted.dtype != torch.bool:
        raise ValueError("coll_sorted must be [N] bool")
    if not 1 <= k < n:
        raise ValueError(f"window {k} must be in [1, {n})")
    if plain or aabb_sorted.device.type == "cpu":
        return sweep_window_masks_plain(aabb_sorted, coll_sorted, k)
    if aabb_sorted.device.type != "cuda" or coll_sorted.device != \
            aabb_sorted.device:
        raise ValueError("sweep_window_masks: tensors must share one "
                         "CUDA device")
    if not (aabb_sorted.is_contiguous() and coll_sorted.is_contiguous()):
        raise ValueError("sweep_window_masks: inputs must be contiguous")
    dev = aabb_sorted.device
    mask = torch.empty((n, k), dtype=torch.uint8, device=dev)
    last = torch.empty((n,), dtype=torch.uint8, device=dev)
    kp = 1 << (k - 1).bit_length()
    grid = (-(-n // _BLOCK_N),)
    with torch.cuda.device(dev):
        _triton_kernel()[grid](
            aabb_sorted, coll_sorted.view(torch.uint8), mask, last, n,
            K=k, KP=kp, BLOCK=_BLOCK_N, num_warps=4)
    sweep_window_masks.launches += 1
    return mask.view(torch.bool), last.view(torch.bool)


sweep_window_masks.launches = 0
