"""Sweep broad phase (physics_tpu/ops/broadphase.py: `body_aabbs`,
`sweep_order`, `_sweep_masks`, `sweep_candidates`, `band_window`,
`bucket_shape`, `sweep_candidates_bucketed`, `compact_pairs`,
`pair_candidates`).

Bodies are sorted by AABB min-x; each rank is tested against its next
`sweep_window` ranks. The bucketed form compacts the hits of each block
of `bucket_block` consecutive ranks, in rank-major order, into that
bucket's `cap` candidate lanes: one launch of the kernel in
ops/sweep_kernel.py. The flat form (pair_buckets off) emits every
(rank, offset) test as a lane from the window masks (the kernel's masks
mode), and `compact_pairs` keeps the first `max_pair_candidates` hits in
emission order. Pairs a window, a bucket or the compaction cannot hold
are counted in `overflow`, never dropped silently.
"""

from __future__ import annotations

from typing import Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import quaternion as quat
from physics_tpu_torch.ops.sweep_kernel import (
    PairCandidates,
    bucketed_candidates,
    sweep_window_masks,
)
from physics_tpu_torch.state import (
    SHAPE_BOX,
    SHAPE_HULL,
    SHAPE_NONE,
    SHAPE_SPHERE,
    SimState,
)

Tensor = torch.Tensor


def body_aabbs(state: SimState) -> Tensor:
    """World AABBs [N, 2, 3] (min, max): the |R|·h extent of each box; a
    bounding sphere of radius params[0] for spheres and hulls (the hull's
    radius is set at scene build)."""
    stype = state.shapes.stype
    params = state.shapes.params
    rot = quat.to_matrix(state.quat)                          # [N,3,3]
    box_ext = torch.sum(torch.abs(rot) * params[:, None, :], dim=-1)
    sphere_ext = params[:, 0:1].expand_as(box_ext)
    round_ = (stype == SHAPE_SPHERE) | (stype == SHAPE_HULL)
    ext = torch.where((stype == SHAPE_BOX)[:, None], box_ext,
                      torch.where(round_[:, None], sphere_ext,
                                  torch.zeros_like(box_ext)))
    return torch.stack([state.pos - ext, state.pos + ext], dim=-2)


def sweep_order(state: SimState, aabbs: Tensor) -> Tensor:
    """Body id per sorted rank: min-x ascending, non-collidable bodies
    (key +inf) last. The sort is STABLE — ties keep body-id order, as
    jnp.argsort does; every rank downstream depends on it."""
    collidable = state.shapes.stype != SHAPE_NONE
    key = torch.where(collidable, aabbs[:, 0, 0],
                      torch.full_like(aabbs[:, 0, 0], float("inf")))
    return torch.argsort(key, stable=True).to(torch.int32)


def _sweep_masks(state: SimState, aabbs: Tensor, k: int,
                 order: Tensor | None = None, plain: bool = False):
    """(order [N], mask [N, k] bool, last_overlap [N] bool): mask[i, d-1]
    ⇔ sorted ranks (i, i+d) AABB-overlap and are both collidable;
    last_overlap flags collidable ranks whose x-interval still overlaps
    rank i+k (pairs may exist beyond the window)."""
    if order is None:
        order = sweep_order(state, aabbs)
    collidable = state.shapes.stype != SHAPE_NONE
    oi = order.long()
    aabb_s = aabbs[oi].contiguous()
    coll_s = collidable[oi].contiguous()
    mask, last = sweep_window_masks(aabb_s, coll_s, k, plain=plain)
    return order, mask, last


def sweep_candidates(state: SimState, aabbs: Tensor, window: int,
                     order: Tensor | None = None,
                     plain: bool = False) -> PairCandidates:
    """The flat sweep's [N·k] candidate lanes, k = min(window, N − 1),
    rank-major: lane i·k + d − 1 tests sorted ranks (i, i + d), body_a =
    order[i], body_b = order[i + d] (0 past the last rank, as the JAX
    package's zero-padded shift leaves it), rank_b = min(i + d, N − 1).
    overflow counts the ranks whose window may be too short."""
    n = state.num_bodies
    k = min(window, n - 1)
    order, mask, last = _sweep_masks(state, aabbs, k, order, plain)
    dev = order.device
    pad_order = torch.cat([order, order.new_zeros((k,))])
    nb_order = torch.stack([pad_order[d:d + n] for d in range(1, k + 1)],
                           dim=1)                            # [N, k]
    ranks = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    offs = torch.arange(1, k + 1, dtype=torch.int32, device=dev)[None, :]
    return PairCandidates(
        order[:, None].expand(n, k).reshape(-1), nb_order.reshape(-1),
        mask.reshape(-1), torch.sum(last.to(torch.int32)).to(torch.int32),
        ranks.expand(n, k).reshape(-1),
        torch.clamp(ranks + offs, max=n - 1).reshape(-1))


def compact_pairs(cand: PairCandidates, max_pairs: int) -> PairCandidates:
    """The first `max_pairs` active candidates in emission order, then the
    inactive ones in theirs (the JAX package's one uint32 sort with the
    mask in bit 31: a stable sort on the inverted mask); the actives
    dropped are added to `overflow`. Unchanged when max_pairs ≤ 0 or no
    larger than the lane count."""
    p = cand.body_a.shape[0]
    if max_pairs <= 0 or p <= max_pairs:
        return cand
    idx = torch.sort((~cand.mask).to(torch.uint8), stable=True)[1][:max_pairs]
    dropped = torch.clamp(torch.sum(cand.mask.to(torch.int32)) - max_pairs,
                          min=0)
    return PairCandidates(cand.body_a[idx], cand.body_b[idx], cand.mask[idx],
                          (cand.overflow + dropped).to(torch.int32),
                          cand.rank_a[idx], cand.rank_b[idx])


def band_window(cfg: SimConfig) -> int:
    """Rank-band half-width the broad phase guarantees: candidates connect
    ranks (r, r+d), 1 ≤ d ≤ band_window. The sweep: sweep_window (min-x
    sorted ranks); env_blocks: K − 1 (the within-env upper triangle of
    packed envs under the identity order, |a − b| < K)."""
    if cfg.broadphase == "env_blocks":
        return max(cfg.env_block_size - 1, 1)
    return cfg.sweep_window


def _round_up128(x: int) -> int:
    return -(-x // 128) * 128


def bucket_shape(n: int, cfg: SimConfig) -> Tuple[int, int, int]:
    """(block, cap, n_blocks) of the rank-block bucket layout."""
    block = max(cfg.bucket_block, 1)
    n_blocks = -(-n // block)
    if cfg.bucket_cap > 0:
        cap = cfg.bucket_cap
    else:
        total = (cfg.max_pair_candidates if cfg.max_pair_candidates > 0
                 else 8 * n)
        cap = max(total // n_blocks, 128)
    cap = _round_up128(cap)
    k = min(band_window(cfg), n - 1)
    cap = min(cap, _round_up128(block * k))
    return block, cap, n_blocks


def sweep_candidates_bucketed(state: SimState, aabbs: Tensor,
                              cfg: SimConfig, order: Tensor | None = None,
                              plain: bool = False) -> PairCandidates:
    """Sweep candidates compacted per bucket of `bucket_block` ranks: each
    bucket keeps its first `cap` hits in (rank, d) order, its misses in
    the lanes after them, as the JAX package's segmented uint32 sort
    (hit flag in bit 31, slot index below) leaves them. One launch of
    ops/sweep_kernel.py's candidates mode from the order on."""
    n = state.num_bodies
    block, cap, _ = bucket_shape(n, cfg)
    if order is None:
        order = sweep_order(state, aabbs)
    return bucketed_candidates(order, aabbs.contiguous(),
                               state.shapes.stype,
                               k=min(cfg.sweep_window, n - 1), block=block,
                               cap=cap, plain=plain)


def pair_candidates(state: SimState, cfg: SimConfig,
                    aabbs: Tensor | None = None,
                    order: Tensor | None = None,
                    plain: bool = False) -> PairCandidates:
    """The sweep's candidates: bucketed (the broad phase the table paths
    take outside the in-kernel one), or with pair_buckets off the flat
    sweep compacted to max_pair_candidates lanes. `aabbs`/`order` may be
    passed when the caller already has them."""
    if cfg.broadphase != "sweep":
        raise NotImplementedError(
            "allpairs and env_block_candidates (env_blocks runs in the "
            "contact-table kernel) are ROADMAP item 1.13.5")
    if aabbs is None:
        aabbs = body_aabbs(state)
    if cfg.pair_buckets:
        return sweep_candidates_bucketed(state, aabbs, cfg, order, plain)
    return compact_pairs(sweep_candidates(state, aabbs, cfg.sweep_window,
                                          order, plain),
                         cfg.max_pair_candidates)
