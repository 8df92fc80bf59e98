"""The sweep broad phase's kernel (csrc/sweep.cu) and its plain PyTorch
versions.

Replaces the TPU kernel `sweep_window_masks` (physics_tpu/ops/
sweep_pallas.py:61, body `_window_mask_kernel` :34-57), which kept the
sorted AABBs in VMEM and unrolled the window loop over lane-shifted
slices, and the segmented sort with which its consumer compacted the
masks into bucketed candidates (physics_tpu/ops/broadphase.py:242
`sweep_candidates_bucketed`).

What it computes, for AABBs sorted by min-x and each rank i and offset
d = 1..k: mask[i, d-1] = rank i+d exists, its min-x starts before i's
max-x, the two boxes overlap on all three axes, and both are collidable;
last[i] = rank i is collidable and rank i+k still x-overlaps it (the
window may be too short). These are the semantics of the JAX package's
XLA branch (physics_tpu/ops/broadphase.py:136-162), which is what that
package runs off the TPU and what the tests hold this port to.

One CUDA kernel has two modes. `sweep_window_masks` writes the [N, k]
masks and the last flags, as the TPU kernel did. `bucketed_candidates`
goes in one launch from the sort order and the unsorted AABBs to every
field of PairCandidates: each bucket of `block` consecutive ranks keeps
its first `cap` hits in (rank, d) order, then its misses in the same
order (the dead lanes the reference's sort leaves there), then slot 0
where block·k < cap; the window-edge ranks and the hits beyond each cap
are counted in `overflow`. On the H100 a cluster of four blocks takes a
bucket: each gathers the bucket's AABBs through the order into shared
memory, turns each warp's 32 consecutive tests of its quarter into a
ballot and places the hits and misses by a block scan over those
ballots and the other quarters' counts (read from their shared memory),
where the TPU needed a sort.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from physics_tpu_torch.state import SHAPE_NONE

Tensor = torch.Tensor


class PairCandidates(NamedTuple):
    body_a: Tensor   # [P] int32
    body_b: Tensor   # [P] int32
    mask: Tensor     # [P] bool
    overflow: Tensor # [] int32 — pairs possibly missed
    rank_a: Tensor   # [P] int32 sorted rank of body_a (rank_a < rank_b)
    rank_b: Tensor   # [P] int32


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


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check_window(n: int, k: int) -> None:
    if not 1 <= k < n:
        raise ValueError(f"window {k} must be in [1, {n})")


def sweep_window_masks(aabb_sorted: Tensor, coll_sorted: Tensor, k: int,
                       plain: bool = False):
    """(mask [N, k] bool, last [N] bool) for AABBs [N, 2, 3] f32 sorted by
    min-x and their collidable flags [N] bool, window k ≥ 1.

    A CPU tensor (or `plain=True`, used to hold the kernel against its
    plain version on the card) runs `sweep_window_masks_plain`; a CUDA
    tensor launches csrc/sweep.cu's masks mode.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    n = aabb_sorted.shape[0]
    if aabb_sorted.shape != (n, 2, 3) or aabb_sorted.dtype != torch.float32:
        raise ValueError(f"aabb_sorted must be [N, 2, 3] f32, got "
                         f"{tuple(aabb_sorted.shape)} {aabb_sorted.dtype}")
    if coll_sorted.shape != (n,) or coll_sorted.dtype != torch.bool:
        raise ValueError("coll_sorted must be [N] bool")
    _check_window(n, k)
    if plain or aabb_sorted.device.type == "cpu":
        return sweep_window_masks_plain(aabb_sorted, coll_sorted, k)
    from physics_tpu_torch import _build

    dev = aabb_sorted.device
    _build.check_operands("sweep window masks", dev,
                          ("aabb_sorted", aabb_sorted, torch.float32,
                           (n, 2, 3)),
                          ("coll_sorted", coll_sorted, torch.bool, (n,)))
    mask = torch.empty((n, k), dtype=torch.uint8, device=dev)
    last = torch.empty((n,), dtype=torch.uint8, device=dev)
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = _build.library().sw_window_masks(
            ptr(aabb_sorted.data_ptr()), ptr(coll_sorted.data_ptr()),
            ptr(mask.data_ptr()), ptr(last.data_ptr()), n, k, _stream(dev))
    _build.check(err, "sw_window_masks")
    sweep_window_masks.launches += 1
    return mask.view(torch.bool), last.view(torch.bool)


sweep_window_masks.launches = 0


def bucketed_candidates_plain(order: Tensor, aabbs: Tensor, stype: Tensor,
                              *, k: int, block: int,
                              cap: int) -> PairCandidates:
    """Plain version of the candidates mode, bucket by bucket without a
    sort: a test's lane is the hits before it when it hits, else the
    bucket's hits plus the misses before it."""
    n = order.shape[0]
    dev = order.device
    oi = order.long()
    mask, last = sweep_window_masks_plain(
        aabbs[oi], (stype != SHAPE_NONE)[oi], k)
    n_blocks = -(-n // block)
    t_all = block * k
    if n_blocks * block != n:
        mask = torch.nn.functional.pad(mask, (0, 0, 0, n_blocks * block - n))
    m2 = mask.reshape(n_blocks, t_all)
    hits = m2.to(torch.int64)
    below = torch.cumsum(hits, dim=1) - hits
    h = hits.sum(dim=1, keepdim=True)
    f = torch.arange(t_all, device=dev).expand(n_blocks, t_all)
    lane = torch.where(m2, below, h + f - below)
    slot = torch.empty_like(lane).scatter_(1, lane, f)[:, :min(cap, t_all)]
    if slot.shape[1] < cap:     # tiny blocks: the other lanes hold slot 0
        slot = torch.nn.functional.pad(slot, (0, cap - slot.shape[1]))
    live = torch.arange(cap, device=dev)[None, :] < h

    base = (torch.arange(n_blocks, device=dev) * block)[:, None]
    rank_a = torch.clamp(base + slot // k, max=n - 1).reshape(-1)
    rank_b = torch.clamp(rank_a.reshape(n_blocks, cap) + 1 + slot % k,
                         max=n - 1).reshape(-1)
    dropped = torch.sum(torch.clamp(h - cap, min=0))
    overflow = (torch.sum(last.to(torch.int64)) + dropped).to(torch.int32)
    return PairCandidates(order[rank_a], order[rank_b], live.reshape(-1),
                          overflow, rank_a.to(torch.int32),
                          rank_b.to(torch.int32))


def bucketed_candidates(order: Tensor, aabbs: Tensor, stype: Tensor, *,
                        k: int, block: int, cap: int,
                        plain: bool = False) -> PairCandidates:
    """The bucketed sweep candidates of N bodies: order [N] int32 (body
    id per sorted rank), aabbs [N, 2, 3] f32 and stype [N] int32 by body,
    window k, buckets of `block` ranks with `cap` lanes each. Fields
    [ceil(N / block)·cap], overflow [] int32.

    A CPU tensor (or `plain=True`) runs `bucketed_candidates_plain`; a
    CUDA tensor launches csrc/sweep.cu's candidates mode (one launch, one
    call at a time a card: the blocks share one overflow counter).
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    n = order.shape[0]
    _check_window(n, k)
    if block < 1 or cap < 1:
        raise ValueError(f"buckets of {block} ranks and {cap} lanes")
    if plain or order.device.type == "cpu":
        return bucketed_candidates_plain(order, aabbs, stype, k=k,
                                         block=block, cap=cap)
    from physics_tpu_torch import _build

    dev = order.device
    _build.check_operands("bucketed candidates", dev,
                          ("order", order, torch.int32, (n,)),
                          ("aabbs", aabbs, torch.float32, (n, 2, 3)),
                          ("stype", stype, torch.int32, (n,)))
    p = -(-n // block) * cap
    ints = torch.empty((4, p), dtype=torch.int32, device=dev)
    mask = torch.empty((p,), dtype=torch.uint8, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = _build.library().sw_bucketed_candidates(
            ptr(order.data_ptr()), ptr(aabbs.data_ptr()),
            ptr(stype.data_ptr()), *[ptr(t.data_ptr()) for t in (
                ints[0], ints[1], mask, ints[2], ints[3], overflow)],
            n, k, block, cap, _stream(dev))
    _build.check(err, "sw_bucketed_candidates")
    bucketed_candidates.launches += 1
    return PairCandidates(ints[0], ints[1], mask.view(torch.bool), overflow,
                          ints[2], ints[3])


bucketed_candidates.launches = 0
