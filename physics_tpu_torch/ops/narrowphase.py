"""Narrow phase (physics_tpu/ops/narrowphase.py): the flat contact buffer
(`Contacts`, `concat_contacts`), the boxes-only ground corners
(`_ground_contacts_boxes`), the banded pair manifolds' slot-major
contacts (`_pair_contacts_boxes_pallas`), their boxes-only dispatch, and
the hull fast-layout predicate (`hulls_fast_path`).

The JAX package picks the ground path by backend: on the TPU the
slot-major `_ground_contacts_boxes` ([k·N], slot s of every body, then
slot s+1), elsewhere the generic body-major `ground_contacts` over
`convex_data`. The port follows the TPU route on every device, so its
contact order within a rank differs from the JAX package's on the CPU; the
generic convex narrow phases themselves are ROADMAP item 1.13.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops.boxbox_batched import (
    _CAP,
    _argmax_unrolled,
    _select,
)
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.ops.contact_table import _BOX_SIGNS
from physics_tpu_torch.ops.narrowphase_banded import (
    NP_ID_EXACT_MAX,
    pair_manifolds_banded,
)
from physics_tpu_torch.state import SHAPE_BOX, SimState

Tensor = torch.Tensor

MAX_FAST_HULL_TYPES = 4   # H² coefficient-table sets + H² segments


class Contacts(NamedTuple):
    """Flat contact buffer. `normal` points from body_b toward body_a;
    body_b == -1 ⇒ the ground. Vector fields are [3, C]."""

    body_a: Tensor       # [C] int32
    body_b: Tensor       # [C] int32
    point: Tensor        # [3, C]
    normal: Tensor       # [3, C]
    depth: Tensor        # [C] (> 0 where active)
    active: Tensor       # [C] bool
    friction: Tensor     # [C]
    restitution: Tensor  # [C]
    key: Tensor          # [C] int32 feature id (pairs ≥ 0, ground < 0,
                         # 0 on inactive slots)


def concat_contacts(*groups: Contacts) -> Contacts:
    groups = [g for g in groups if g is not None and g.body_a.shape[0] > 0]
    if len(groups) == 1:
        return groups[0]
    return Contacts(*[
        torch.cat([getattr(g, f) for g in groups],
                  dim=1 if f in ("point", "normal") else 0)
        for f in Contacts._fields
    ])


def hulls_fast_path(state: SimState, cfg: SimConfig) -> bool:
    """True when the scene is hulls-only with a small hull library: one
    hull type, or up to MAX_FAST_HULL_TYPES with the OBB prefilter that
    segments candidates by type pair. Depends on cfg and shapes only."""
    n_hulls = state.hulls.verts.shape[0]
    return bool(
        cfg.hulls_only and cfg.hull_fast
        and 1 <= n_hulls <= MAX_FAST_HULL_TYPES
        and (n_hulls == 1 or cfg.hull_prefilter_cap > 0)
        and state.hulls.verts.shape[1] > 1
    )


def banded_pairs(cfg: SimConfig) -> bool:
    """True when pair contacts come from the banded pair-manifold kernel
    (the bucketed sweep bounds every tile's rank span)."""
    return bool(cfg.boxes_only and cfg.narrowphase_pallas
                and cfg.broadphase == "sweep" and cfg.pair_buckets)


def _ground_contacts_boxes(state: SimState, cfg: SimConfig) -> Contacts:
    """The 8 box corners against y = ground_height, the deepest
    min(max_contacts_per_pair, 8) per body, slot-major [k·N]. Ground keys
    are −(body·8 + corner + 1)."""
    n = state.num_bodies
    k = min(cfg.max_contacts_per_pair, 8)
    r9 = v3.quat_to_mat(state.quat)
    hx, hy, hz = (state.shapes.params[:, 0], state.shapes.params[:, 1],
                  state.shapes.params[:, 2])
    px, py, pz = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    valid_base = (state.inv_mass > 0.0) & (state.shapes.stype == SHAPE_BOX)

    pts, score = [], []
    for sx, sy, sz in _BOX_SIGNS:
        wx, wy, wz = sx * hx, sy * hy, sz * hz
        cx = px + r9[0] * wx + r9[1] * wy + r9[2] * wz
        cy = py + r9[3] * wx + r9[4] * wy + r9[5] * wz
        cz = pz + r9[6] * wx + r9[7] * wy + r9[8] * wz
        pts.append((cx, cy, cz))
        d = cfg.ground_height - cy
        score.append(torch.where(valid_base & (d > 0.0), d,
                                 torch.full_like(d, -float("inf"))))

    body = torch.arange(n, dtype=torch.int32, device=state.device)
    sel_p, sel_d, sel_a, sel_k = [[], [], []], [], [], []
    for _ in range(k):
        best, bidx = _argmax_unrolled(score)
        active = torch.isfinite(best) & (best > 0.0)
        pt = _select(bidx, pts)
        for c in range(3):
            sel_p[c].append(pt[c])
        sel_d.append(torch.where(active, best, torch.zeros_like(best)))
        sel_a.append(active)
        sel_k.append(torch.where(active, -(body * 8 + bidx + 1),
                                 torch.zeros_like(body)))
        score = [torch.where(bidx == s, torch.full_like(score[s],
                                                        -float("inf")),
                             score[s]) for s in range(8)]

    zeros = torch.zeros((k * n,), dtype=torch.float32, device=state.device)
    return Contacts(
        body_a=body.repeat(k),
        body_b=torch.full((k * n,), -1, dtype=torch.int32,
                          device=state.device),
        point=torch.stack([torch.cat(sel_p[c]) for c in range(3)]),
        normal=torch.stack([zeros, torch.ones_like(zeros), zeros]),
        depth=torch.cat(sel_d),
        active=torch.cat(sel_a),
        friction=state.shapes.friction.repeat(k),
        restitution=state.shapes.restitution.repeat(k),
        key=torch.cat(sel_k),
    )


def _pair_contacts_boxes_pallas(state: SimState, cand: PairCandidates,
                                cfg: SimConfig, geom: Tensor,
                                plain: bool = False,
                                chunked: bool = False) -> Contacts:
    """The banded pair-manifold kernel's rows (ops/narrowphase_banded.py)
    as slot-major [kk·P] contacts. `geom` is the rank-space geometry table
    of the step (its narrow-phase block is the kernel's body table). Pair
    keys are (min id·n + max id)·8 + source slot while n²·8 fits in int32,
    else 0; the endpoint ids ride the kernel's rows."""
    n = state.num_bodies
    p0 = cand.body_a.shape[0]
    rows, _, kk = pair_manifolds_banded(state, cand, cfg, geom, plain=plain,
                                        chunked=chunked)
    if n < NP_ID_EXACT_MAX:
        zero = torch.zeros_like(cand.body_a)
        ia = torch.where(cand.mask, rows[5 * kk + 5, :p0].to(torch.int32),
                         zero)
        ib = torch.where(cand.mask, rows[5 * kk + 6, :p0].to(torch.int32),
                         zero)
    else:
        ia, ib = cand.body_a, cand.body_b

    has_key = n * n * _CAP < 2**31 - 1
    if has_key:
        base_key = (torch.minimum(ia, ib) * n + torch.maximum(ia, ib)) * _CAP
    point_c, depth_c, act_c, key_c = [[], [], []], [], [], []
    for s in range(kk):
        for c in range(3):
            point_c[c].append(rows[5 * s + c, :p0])
        d = rows[5 * s + 3, :p0]
        depth_c.append(d)
        active = d > 0.0
        act_c.append(active)
        if has_key:
            bidx = rows[5 * s + 4, :p0].to(torch.int32)
            key_c.append(torch.where(active, base_key + bidx,
                                     torch.zeros_like(base_key)))
        else:
            key_c.append(torch.zeros_like(ia))

    return Contacts(
        body_a=ia.repeat(kk),
        body_b=ib.repeat(kk),
        point=torch.stack([torch.cat(point_c[c]) for c in range(3)]),
        normal=rows[5 * kk:5 * kk + 3, :p0].repeat(1, kk),
        depth=torch.cat(depth_c),
        active=torch.cat(act_c),
        friction=rows[5 * kk + 3, :p0].repeat(kk),
        restitution=rows[5 * kk + 4, :p0].repeat(kk),
        key=torch.cat(key_c),
    )


def ground_contacts(state: SimState, cfg: SimConfig) -> Contacts:
    """Ground contacts of a boxes-only scene (the TPU route of the JAX
    dispatch); other shapes are ROADMAP item 1.13."""
    if not cfg.boxes_only:
        raise NotImplementedError(
            "ground contacts of hulls and spheres (convex_data) are ROADMAP "
            "item 1.13")
    return _ground_contacts_boxes(state, cfg)


def pair_contacts(state: SimState, cand: PairCandidates, cfg: SimConfig,
                  geom: Tensor, plain: bool = False,
                  chunked: bool = False) -> Contacts:
    """Pair contacts of the bucketed candidates (`chunked`: one rank's
    slice of them) through the banded pair-manifold kernel; the other
    narrow phases are ROADMAP item 1.13."""
    if not banded_pairs(cfg):
        raise NotImplementedError(
            "only the banded box narrow phase (boxes_only, "
            "narrowphase_pallas, bucketed sweep) is ported; the generic "
            "narrow phases are ROADMAP item 1.13")
    return _pair_contacts_boxes_pallas(state, cand, cfg, geom, plain=plain,
                                       chunked=chunked)
