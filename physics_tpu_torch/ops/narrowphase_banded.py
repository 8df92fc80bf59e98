"""Banded box-box pair manifolds: the plain PyTorch version of the TPU
kernel's rows (physics_tpu/ops/narrowphase_pallas.py
`pair_manifolds_banded`), its operands and its static tile bases. The
CUDA kernel (csrc/narrowphase_banded.cu, wrapped by ops/narrowphase.py
`banded_contacts`) computes the same manifolds but writes the contact
list itself; these rows stay the plain composition's middle step and the
row contract the CPU parity tests hold against the JAX kernel.

The bucketed sweep's candidate lanes are cut into tiles of `tile` lanes;
tile t reads the bodies of ranks [base_t, base_t + pallas_window) of the
rank-space body table. Bases are static: tile t covers whole buckets of
`bucket_block` ranks, whose candidates reach at most `sweep_window` ranks
further, so a span wider than the window is a configuration error, raised
here before anything runs, never a silent drop. In chunked mode (one
rank's slice of the candidate lanes, in the row-sharded step) the slice
need not start at a bucket, so each tile's base is computed from its
lanes instead: its lowest live rank, rounded down to 128. A lane whose
endpoint falls outside its window reads as empty (−1) in either mode.

For each lane the 15-axis box-box manifold gives its kk deepest valid
points. Rows [5·kk + 7, Pp]: for each pick
s < kk, rows 5s:5s+5 = point xyz, depth (0 when inactive), source
manifold slot; then normal xyz (B → A), friction √(μa·μb), restitution
max, and the two body ids. The TPU kernel's zero rows up to a multiple
of 8 (sublane alignment) are not written: nothing reads them. An empty lane
reads two all-zero bodies, whose movable 0 leaves every slot inactive.

Replaces the TPU kernel `pair_manifolds_banded` (physics_tpu/ops/
narrowphase_pallas.py:128, body `_make_np_kernel` :59-125), which
gathered each lane's bodies with one-hot matmuls through hi/lo bf16
splits (about 2⁻¹⁷ of each value); here they are exact loads, so f32 rows
differ from the TPU kernel's by that split's rounding, and the integer
rows (slots, ids) agree. The zero rows of an empty lane: points, depths
and slots 0, normal −0, friction and restitution 0, ids 0.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.ops.boxbox_batched import (
    _CAP,
    _argmax_unrolled,
    _select,
    box_box_manifold_batched,
)
from physics_tpu_torch.ops.broadphase import PairCandidates, bucket_shape
from physics_tpu_torch.ops.contact_table import _round_up
from physics_tpu_torch.state import SimState

Tensor = torch.Tensor

# endpoint body ids ride the manifold rows exactly below this count (the
# TPU kernel's hi/lo bf16 split carried them exactly up to 2¹⁶)
NP_ID_EXACT_MAX = 1 << 16
_BIG_NEG = -1e30


def np_shape(n: int, p0: int, cfg: SimConfig) -> Tuple[int, int, int]:
    """(kk, tile, pp) for p0 candidate lanes over n bodies."""
    kk = min(cfg.max_contacts_per_pair, _CAP)
    tile = min(cfg.pallas_tile, max(_round_up(p0, 128), 128))
    return kk, tile, _round_up(p0, tile)


def body_table_width(n: int, cfg: SimConfig) -> int:
    """NPAD of the rank-space body table the kernel reads."""
    wtot = cfg.pallas_window
    return _round_up(max(n + wtot, wtot), 128)


@functools.cache
def _static_bases(n: int, p0: int, cfg: SimConfig,
                  device: torch.device) -> Tensor:
    """Window start of each tile: tile t covers candidate lanes
    [t·tile, (t+1)·tile), i.e. buckets [t·tile/cap, ((t+1)·tile − 1)/cap],
    whose ranks span [lo·block, hi·block + block − 1 + sweep_window].
    Cached per shape: every caller shares the one (read-only) tensor, so
    the host copies it to the device once; never evicted, so a CUDA graph
    that captured it can replay (engine.DeviceStepper)."""
    _, tile, pp = np_shape(n, p0, cfg)
    wtot = cfg.pallas_window
    npad = body_table_width(n, cfg)
    block, cap, _ = bucket_shape(n, cfg)
    k_sweep = min(cfg.sweep_window, n - 1)
    t = np.arange(pp // tile)
    lo_blk = (t * tile) // cap
    hi_blk = ((t + 1) * tile - 1) // cap
    max_rank = np.minimum(hi_blk * block + block - 1 + k_sweep, n - 1)
    bases = np.clip((lo_blk * block // 128) * 128, 0, npad - wtot)
    span = int((max_rank - bases).max()) + 1
    if span > wtot:
        raise ValueError(
            f"banded narrow phase: bucketed tile rank span {span} > "
            f"pallas_window {wtot}; raise pallas_window or lower "
            f"bucket_block/pallas_tile")
    return torch.as_tensor(bases.astype(np.int32), device=device)


def _tile_min_bases(mask: Tensor, rank_a: Tensor, tile: int, npad: int,
                    wtot: int) -> Tensor:
    """Window start of each tile from its lanes: the lowest live rank
    (npad − 1 when none is live), rounded down to 128, within
    [0, npad − wtot]."""
    key = torch.where(mask, rank_a, npad - 1)
    tmin = key.reshape(-1, tile).amin(dim=1)
    return torch.clamp(torch.div(tmin, 128, rounding_mode="floor") * 128,
                       0, npad - wtot).to(torch.int32)


def pair_operands(state: SimState, cand: PairCandidates, cfg: SimConfig,
                  geom: Tensor, chunked: bool = False):
    """(bases [Pp / tile] int32, la, lb [Pp] int32 window-local endpoint
    ranks, −1 for empty or out-of-band lanes, tile, kk). `chunked`: cand
    is a slice of the bucketed lanes, and the bases come from the lanes
    (_tile_min_bases) instead of the bucket layout."""
    n = state.num_bodies
    p0 = cand.body_a.shape[0]
    kk, tile, pp = np_shape(n, p0, cfg)
    npad = body_table_width(n, cfg)
    if geom.shape != (48, npad):
        raise ValueError(f"banded narrow phase: pass the rank-space "
                         f"geometry table [48, {npad}] (unified_geom)")
    wtot = cfg.pallas_window
    pad = (0, pp - p0)
    mask = torch.nn.functional.pad(cand.mask, pad)
    rank_a = torch.nn.functional.pad(cand.rank_a, pad)
    if chunked:
        bases = _tile_min_bases(mask, rank_a, tile, npad, wtot)
    else:
        bases = _static_bases(n, p0, cfg, geom.device)
    base = bases.repeat_interleave(tile)
    la = rank_a - base
    lb = torch.nn.functional.pad(cand.rank_b, pad) - base
    ok = mask & (la >= 0) & (la < wtot) & (lb >= 0) & (lb < wtot)
    la = torch.where(ok, la, -1).to(torch.int32)
    lb = torch.where(ok, lb, -1).to(torch.int32)
    return bases, la, lb, tile, kk


def pair_manifolds_banded_plain(geom: Tensor, bases: Tensor, la: Tensor,
                                lb: Tensor, *, tile: int, kk: int) -> Tensor:
    """Plain version of the kernel, all lanes at once: rows [R, Pp]."""
    base = bases.to(torch.int64).repeat_interleave(tile)

    def lanes(loc):
        rank = base + torch.clamp(loc.to(torch.int64), min=0)
        g = geom[24:48, rank]
        return torch.where((loc >= 0)[None], g, torch.zeros_like(g))

    ga, gb = lanes(la), lanes(lb)
    man = box_box_manifold_batched(
        (ga[0], ga[1], ga[2]), tuple(ga[3 + k] for k in range(9)),
        (ga[12], ga[13], ga[14]),
        (gb[0], gb[1], gb[2]), tuple(gb[3 + k] for k in range(9)),
        (gb[12], gb[13], gb[14]))
    movable = (ga[17] > 0.0) | (gb[17] > 0.0)
    big_neg = torch.full_like(ga[0], _BIG_NEG)
    score = [torch.where(man.valid[s] & movable, man.depth[s], big_neg)
             for s in range(_CAP)]
    rows = []
    for _ in range(kk):
        best, bidx = _argmax_unrolled(score)
        pt = _select(bidx, man.points)
        rows += [pt[0], pt[1], pt[2],
                 torch.where(best > 0.0, best, torch.zeros_like(best)),
                 bidx.to(torch.float32)]
        score = [torch.where(bidx == s, big_neg, score[s])
                 for s in range(_CAP)]
    rows += [man.normal[0], man.normal[1], man.normal[2],
             torch.sqrt(ga[15] * gb[15]), torch.maximum(ga[16], gb[16]),
             ga[18], gb[18]]
    return torch.stack(rows)


def pair_manifolds_banded(state: SimState, cand: PairCandidates,
                          cfg: SimConfig, geom: Tensor,
                          chunked: bool = False) -> Tuple[Tensor, int, int]:
    """The manifold rows of every candidate lane, plain version on any
    device (the kernel writes contacts, not rows: ops/narrowphase.py
    banded_contacts). Returns (rows [R, Pp], Pp, kk), the lane axis
    padded to the tile. `chunked=True`: cand is one rank's slice of the
    bucketed lanes (window bases from the lanes; see pair_operands).

    `geom` is the rank-space geometry table [48, NPAD] of the step's sweep
    order (unified_geom at body_table_width): its narrow-phase block
    (rows 24:48) is the body table."""
    bases, la, lb, tile, kk = pair_operands(state, cand, cfg, geom, chunked)
    rows = pair_manifolds_banded_plain(geom, bases, la, lb, tile=tile, kk=kk)
    return rows, la.shape[0], kk
