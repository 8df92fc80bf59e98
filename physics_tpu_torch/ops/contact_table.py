"""Fused bucket-aligned contact table: CUDA kernel and its plain PyTorch
version (physics_tpu/ops/contact_table.py).

One bucket = 128 consecutive ranks. For each bucket the table holds
`ccap` contact slots: the box-box manifolds of the bucket's candidate
pairs (at most `kk` deepest points per pair), then the ground corners of
the bucket's own ranks (at most `kg` per body), compacted in that
emission order. Contact b's endpoints lie within ranks
[b·128, b·128 + 128 + band_window), so the banded solve can use static
bucket bases. The row layout (CT_* constants) and the component-form
feature keys are the JAX package's, because the warm start across steps
and the anchored refresh depend on them.

The candidates come from the bucketed sweep (`cand`), or, with
`cand=None`, from the in-kernel broad phase: the pairs (r, r + d),
1 ≤ d ≤ bp_k, of the bucket's ranks whose window AABBs overlap,
compacted d-major; in packed-env mode (broadphase="env_blocks") only the
pairs inside one env of env_block_size bodies. `gate=` passes the
persisted block of every bucket whose gate is 0 through unchanged (the
displacement-gated refresh).

Replaces the TPU kernel `bucket_contact_table` (physics_tpu/ops/
contact_table.py:844, body `_make_ct_kernel` :166-747). That kernel
moved data with one-hot matmuls and hi/lo bf16 splits, because the TPU
has no gather in VMEM; here geometry is read by index, compaction is a
block-wide scan, and every value is exact f32. Its f32 rows therefore
differ from the TPU kernel's by the split's rounding, about 2⁻¹⁷ of each
value; the integer rows (keys, activity, ranks) and the meta counters
are identical.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.maths import vec3c as v3
from physics_tpu_torch.ops.boxbox_batched import (
    _CAP,
    _argmax_unrolled,
    _select,
    box_box_manifold_batched,
)
from physics_tpu_torch.ops.broadphase import (
    PairCandidates,
    band_window,
    bucket_shape,
)
from physics_tpu_torch.state import SHAPE_BOX, SHAPE_HULL, SimState

Tensor = torch.Tensor

# contact-table rows (f32 [rows, NB·ccap])
CT_PT = 0        # 0:3  contact point
CT_N = 3         # 3:6  normal (B→A)
CT_D = 6         # depth
CT_MU = 7        # friction
CT_REST = 8      # restitution
CT_ACT = 9       # 1.0 = active
CT_KL = 10       # key low: max body id (pair) / body id (ground)
CT_KH = 11       # key high: min body id (pair) / 0 (ground)
CT_KSGN = 12     # 1.0 ⇒ ground contact
CT_RA = 13       # rank of endpoint a (lower rank)
CT_RB1 = 14      # rank of endpoint b + 1 (0 = ground)
CT_KS = 15       # key slot: manifold slot / corner id
CT_ROWS = 16
# anchored extension (cfg.contact_rebuild > 1): body-frame anchors so the
# solve can re-derive point/normal/depth from current transforms
CT_AAX = 16      # 16:19 anchor in A's frame: R_aᵀ(pt₀ − pos_a)
CT_BAX = 19      # 19:22 anchor in B's frame; world pt₀ for ground
CT_NLOC = 22     # 22:25 normal in A's frame
CT2_ROWS = 32

GEOM_ROWS = 24   # rows of the narrow-phase block of the unified table
BLOCK = 128      # ranks per bucket

_BOX_SIGNS = [
    (sx, sy, sz)
    for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)
]
_BIG_NEG = -1e30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def geom_pad(n: int, cfg: SimConfig) -> Tuple[int, int]:
    """(wtot, npad) of the rank-space geometry table — the formulas the
    JAX package shares between its table and solve kernels."""
    nb = -(-n // BLOCK)
    wtot = _round_up(BLOCK + min(band_window(cfg), BLOCK), 128)
    npad = max(_round_up(n + wtot, 128), nb * BLOCK + wtot)
    return wtot, npad


def unified_geom(state: SimState, cfg: SimConfig, order: Tensor | None,
                 hulls: bool = False, npad: int | None = None,
                 plain: bool = False) -> Tensor:
    """The rank-space geometry table [48, NPAD] shared by the contact
    table and the solve (NPAD from geom_pad unless `npad` is given: the
    generic banded path sizes it to its solve window, and its pair
    manifolds read the narrow-phase block):

      rows  0:24  solve block: pos | world I⁻¹ row-major | inv_mass | vel |
                  omega | quat (19:23) | 0
      rows 24:48  narrow-phase block: pos | world R row-major | half
                  extents | friction | restitution | movable·is_shape |
                  body id | is_shape | tail ×4
    Box mode: is_shape = is_box, tail = 0. Hull mode (the hull table):
    the half extents are the hull type's local-AABB half extents, row 43
    carries is_hull·(1 + hull type) so each candidate lane reads its
    ordered type pair, and rows 44:47 hold the world OBB centre
    pos + R·(local-AABB centre), then 0.
    Column r is the body of rank r (`order[r]`, int32; body r when
    `order` is None, the packed envs' identity order); columns ≥ N are
    zero.

    A CPU tensor (or `plain=True`) runs the plain version; a CUDA
    tensor launches csrc/geom_table.cu, bit for bit the same.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    n = state.num_bodies
    if npad is None:
        _, npad = geom_pad(n, cfg)
    if plain or state.device.type == "cpu":
        return unified_geom_plain(state, order, hulls, npad)
    if state.device.type != "cuda":
        raise ValueError(f"geometry table: unsupported device {state.device}")
    return _launch_geom(state, order, hulls, npad)


unified_geom.launches = 0


def _hull_boxes(hs) -> Tuple[Tensor, Tensor]:
    """(centre, half extents) [H, 3] of each hull type's local AABB."""
    vcap = hs.verts.shape[1]
    vmask = (torch.arange(vcap, device=hs.verts.device)[None, :]
             < hs.vert_count[:, None])[..., None]           # [H, V, 1]
    big = torch.full_like(hs.verts, 1e30)
    lo_t = torch.amin(torch.where(vmask, hs.verts, big), dim=1)
    hi_t = torch.amax(torch.where(vmask, hs.verts, -big), dim=1)
    return (lo_t + hi_t) * 0.5, (hi_t - lo_t) * 0.5


def unified_geom_plain(state: SimState, order: Tensor | None, hulls: bool,
                       npad: int) -> Tensor:
    """unified_geom in PyTorch operations."""
    n = state.num_bodies
    movable = (state.inv_mass > 0.0).to(torch.float32)
    r9 = v3.quat_to_mat(state.quat)
    iw9 = v3.sandwich(r9, v3.mat_unpack(state.inv_inertia))
    zero = torch.zeros((n,), dtype=torch.float32, device=state.device)
    pos3 = [state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]]
    if hulls:
        nh = state.hulls.verts.shape[0]
        co_t, hh_t = _hull_boxes(state.hulls)
        hidx = torch.clamp(state.shapes.hull_index, 0, nh - 1).long()
        co_b = co_t[hidx]                                   # [n, 3]
        hh_b = hh_t[hidx]
        half3 = [hh_b[:, 0], hh_b[:, 1], hh_b[:, 2]]
        tail = [pos3[c] + r9[3 * c] * co_b[:, 0]
                + r9[3 * c + 1] * co_b[:, 1]
                + r9[3 * c + 2] * co_b[:, 2] for c in range(3)] + [zero]
        is_shape = ((state.shapes.stype == SHAPE_HULL).to(torch.float32)
                    * (1.0 + hidx.to(torch.float32)))
    else:
        is_shape = (state.shapes.stype == SHAPE_BOX).to(torch.float32)
        half3 = [state.shapes.params[:, 0], state.shapes.params[:, 1],
                 state.shapes.params[:, 2]]
        tail = [zero] * 4
    rows = torch.stack(
        pos3 + list(iw9)
        + [state.inv_mass,
           state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
           state.omega[:, 0], state.omega[:, 1], state.omega[:, 2],
           state.quat[:, 0], state.quat[:, 1], state.quat[:, 2],
           state.quat[:, 3], zero]
        + pos3 + list(r9) + half3
        + [state.shapes.friction, state.shapes.restitution,
           movable * is_shape,
           torch.arange(n, dtype=torch.float32, device=state.device),
           is_shape]
        + tail)                                            # [48, N]
    if order is not None:
        rows = rows[:, order.long()]
    geom = torch.zeros((48, npad), dtype=torch.float32, device=state.device)
    geom[:, :n] = rows
    return geom


def _launch_geom(state: SimState, order: Tensor | None, hulls: bool,
                 npad: int) -> Tensor:
    from physics_tpu_torch import _build

    n, dev = state.num_bodies, state.device
    if npad < n:
        raise ValueError(f"geometry table: NPAD {npad} < {n} bodies")
    f32, i32 = torch.float32, torch.int32
    sh = state.shapes
    ops = [("pos", state.pos.contiguous(), f32, (n, 3)),
           ("quat", state.quat.contiguous(), f32, (n, 4)),
           ("vel", state.vel.contiguous(), f32, (n, 3)),
           ("omega", state.omega.contiguous(), f32, (n, 3)),
           ("inv_mass", state.inv_mass.contiguous(), f32, (n,)),
           ("inv_inertia", state.inv_inertia.contiguous(), f32, (n, 3, 3)),
           ("stype", sh.stype.contiguous(), i32, (n,)),
           ("params", sh.params.contiguous(), f32, (n, 3)),
           ("hull_index", sh.hull_index.contiguous(), i32, (n,)),
           ("friction", sh.friction.contiguous(), f32, (n,)),
           ("restitution", sh.restitution.contiguous(), f32, (n,))]
    if order is not None:
        ops.append(("order", order, i32, (n,)))
    nh = 0
    if hulls:
        nh = state.hulls.verts.shape[0]
        co_t, hh_t = _hull_boxes(state.hulls)
        ops += [("hull centre", co_t.contiguous(), f32, (nh, 3)),
                ("hull half", hh_t.contiguous(), f32, (nh, 3))]
    _build.check_operands("geometry table", dev, *ops)
    t = {name: x for name, x, _, _ in ops}
    geom = torch.empty((48, npad), dtype=f32, device=dev)

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)
    with torch.cuda.device(dev):
        err = _build.library().gt_geom_table(
            *[ptr(t.get(k)) for k in (
                "pos", "quat", "vel", "omega", "inv_mass", "inv_inertia",
                "stype", "params", "hull_index", "friction", "restitution",
                "order", "hull centre", "hull half")],
            ptr(geom), n, nh, npad,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "gt_geom_table")
    unified_geom.launches += 1
    return geom


def table_shape(n: int, cfg: SimConfig) -> Tuple[int, int, int]:
    """(nb, ccap, cp) of the contact table for an n-body scene."""
    nb = -(-n // BLOCK)
    if cfg.bucket_ccap > 0:
        ccap = _round_up(cfg.bucket_ccap, 128)
    else:
        total = cfg.max_contacts if cfg.max_contacts > 0 else 6 * n
        ccap = _round_up(max(total // nb, 128), 128)
    return nb, ccap, nb * ccap


def table_keys(table: Tensor) -> Tensor:
    """Component-form key rows → [2, C] int32 for cross-step storage:
    row0 = KL | (2·KS + KSGN) << 16, row1 = KH + 1; zeros = inactive."""
    act = table[CT_ACT] > 0.0
    row0 = (table[CT_KL].to(torch.int32)
            + ((2 * table[CT_KS].to(torch.int32)
                + table[CT_KSGN].to(torch.int32)) << 16))
    row1 = table[CT_KH].to(torch.int32) + 1
    z = torch.zeros_like(row0)
    return torch.stack([torch.where(act, row0, z), torch.where(act, row1, z)])


def table_keys_scalar(table: Tensor, n: int, pair_stride: int,
                      ground_stride: int) -> Tensor:
    """The generic paths' packed int32 key of each slot — pair: (min·n +
    max)·pair_stride + slot, ground: −(body·ground_stride + slot + 1), 0
    inactive — to compare a table's contact set with theirs (valid while
    the pair key fits int32)."""
    act = table[CT_ACT] > 0.0
    ks = table[CT_KS].to(torch.int32)
    kl = table[CT_KL].to(torch.int32)
    pair = (table[CT_KH].to(torch.int32) * n + kl) * pair_stride + ks
    gnd = -(kl * ground_stride + ks + 1)
    return torch.where(act, torch.where(table[CT_KSGN] > 0.0, gnd, pair), 0)


def prev_key_cols(pkey: Tensor, plam: Tensor) -> Tensor:
    """(keys [2, C] int32, λ [3, C]) of the previous step → the [C, 8]
    columns the warm match reads: ck (−1 inactive), KH (−1 inactive), 0,
    activity, λn, λt1, λt2, 0."""
    act_p = pkey[0] != 0
    neg1 = torch.full_like(plam[0], -1.0)
    zero = torch.zeros_like(plam[0])
    return torch.stack([
        torch.where(act_p, pkey[0].to(torch.float32), neg1),
        torch.where(act_p, (pkey[1] - 1).to(torch.float32), neg1),
        zero,
        act_p.to(torch.float32),
        plam[0], plam[1], plam[2],
        zero,
    ], dim=1).contiguous()


class GateOperands(NamedTuple):
    """What the displacement gate of a refresh reads
    (solver/contacts.py refresh_gate): the poses, contact_ref [n, 7], the
    half extents, the rank order (None: the identity), the number of
    buckets and the threshold vel_factor·slop (compared in f32)."""
    pos: Tensor
    quat: Tensor
    ref: Tensor
    params: Tensor
    order: Tensor | None
    nb: int
    thr: float


def table_prep(pkey: Tensor, plam: Tensor, gate: GateOperands | None = None
               ) -> Tuple[Tensor, Tensor | None, Tensor | None]:
    """The operands a contact table reads that are built before it, in
    one launch of csrc/table_prep.cu: the previous step's key columns
    [C, 8] (prev_key_cols' bytes) from keys [2, C] int32 and λ [3, C]
    (views whose rows are strided, as the sharded table's bucket range,
    are read in place); with `gate`, also the refresh gate [NB] int32
    (refresh_gate's decisions) and contact_ref with the fired buckets'
    bodies reset to their poses, [n, 7] (fired_ref's). Returns (columns,
    gate or None, ref or None).

    CUDA tensors only: for CPU tensors the callers take the plain
    versions, prev_key_cols here and solver/contacts.py refresh_gate and
    fired_ref (table_operands, refresh_prep).
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    from physics_tpu_torch import _build

    dev = pkey.device
    if dev.type != "cuda":
        raise ValueError(f"table prep: unsupported device {dev}")
    c = pkey.shape[1]
    if pkey.stride(1) != 1:
        pkey = pkey.contiguous()
    if plam.stride(1) != 1:
        plam = plam.contiguous()
    f32, i32 = torch.float32, torch.int32
    if not (pkey.dtype == i32 and pkey.shape == (2, c) and plam.dtype == f32
            and plam.shape == (3, c) and plam.device == dev):
        raise ValueError(f"table prep: keys must be int32 [2, C] and λ f32 "
                         f"[3, C] on {dev}")
    cols = torch.empty((c, 8), dtype=f32, device=dev)
    bodies = [None] * 5      # pos, quat, contact_ref, params, order
    gate_out = ref_out = None
    n = nb = 0
    thr = 0.0
    if gate is not None:
        n, nb, thr = gate.pos.shape[0], gate.nb, gate.thr
        ops = [("pos", gate.pos.contiguous(), f32, (n, 3)),
               ("quat", gate.quat.contiguous(), f32, (n, 4)),
               ("contact_ref", gate.ref.contiguous(), f32, (n, 7)),
               ("params", gate.params.contiguous(), f32, (n, 3))]
        if gate.order is not None:
            ops.append(("order", gate.order.contiguous(), i32, (n,)))
        _build.check_operands("table prep", dev, *ops)
        bodies[:len(ops)] = [x for _, x, _, _ in ops]
        gate_out = torch.empty((nb,), dtype=i32, device=dev)
        ref_out = torch.empty((n, 7), dtype=f32, device=dev)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(dev):
        err = _build.library().tp_table_prep(
            ptr(pkey), pkey.stride(0), ptr(plam), plam.stride(0), ptr(cols),
            c, *[ptr(t) for t in bodies], ptr(gate_out), ptr(ref_out), n, nb,
            ctypes.c_float(thr),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "tp_table_prep")
    table_prep.launches += 1
    return cols, gate_out, ref_out


table_prep.launches = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _face_sat_sep(t, ra, rb, ha, hb):
    """Best separation over the 6 face axes (> 0 ⇒ no contact)."""
    cabs = [[torch.abs(ra[i] * rb[j] + ra[3 + i] * rb[3 + j]
                       + ra[6 + i] * rb[6 + j]) for j in range(3)]
            for i in range(3)]
    sep_best = None
    for i in range(3):
        ut = ra[i] * t[0] + ra[3 + i] * t[1] + ra[6 + i] * t[2]
        rad = (ha[i] + hb[0] * cabs[i][0] + hb[1] * cabs[i][1]
               + hb[2] * cabs[i][2])
        s = torch.abs(ut) - rad
        sep_best = s if sep_best is None else torch.maximum(sep_best, s)
    for j in range(3):
        wt = rb[j] * t[0] + rb[3 + j] * t[1] + rb[6 + j] * t[2]
        rad = (hb[j] + ha[0] * cabs[0][j] + ha[1] * cabs[1][j]
               + ha[2] * cabs[2][j])
        sep_best = torch.maximum(sep_best, torch.abs(wt) - rad)
    return sep_best


def _compact_lanes(keep: Tensor, la: Tensor, lb: Tensor, out_cap: int):
    """Order-preserving per-bucket compaction of candidate lanes [NB, L]
    into out_cap lanes (empty = −1); returns (la, lb, dropped [NB])."""
    nb = keep.shape[0]
    slot = torch.cumsum(keep.to(torch.int64), dim=1) - keep.to(torch.int64)
    ok = keep & (slot < out_cap)
    out_a = torch.full((nb, out_cap + 1), -1, dtype=torch.int32,
                       device=la.device)
    out_b = out_a.clone()
    idx = torch.where(ok, slot, torch.full_like(slot, out_cap))
    out_a.scatter_(1, idx, torch.where(ok, la, -1))
    out_b.scatter_(1, idx, torch.where(ok, lb, -1))
    dropped = torch.clamp(keep.sum(dim=1) - out_cap, min=0)
    return out_a[:, :out_cap], out_b[:, :out_cap], dropped


def _bucket_starts(nb: int, bucket0: int, device) -> Tensor:
    """First rank of each of the nb buckets from bucket0 on, [NB, 1]."""
    return (bucket0 + torch.arange(nb, device=device,
                                   dtype=torch.int64))[:, None] * BLOCK


def inkernel_candidates(geom: Tensor, nb: int, bucket0: int, bp_k: int,
                        cap: int, env_k: int = 0):
    """The in-kernel broad phase of the NB buckets from bucket0 on: the
    raw pairs (a, a + d) of window-local ranks a in [0, 128) and
    d in [1, bp_k] whose window AABBs (|R|·half extents about pos, from
    the narrow-phase block) overlap on all three axes, both bodies live
    (row 43) and one movable (row 41); with env_k only pairs inside one
    env, (a mod env_k) + d < env_k. They are compacted d-major, then by
    a — the TPU kernel's row-major prefix over its [bp_k, lanes] raw set
    — into `cap` lanes. Returns (la, lb [NB, cap] int32, −1 empty;
    dropped [NB], raw survivors beyond cap; winovf [NB], ranks whose
    x-interval still overlaps rank a + bp_k, pairs the window may miss;
    0 with env_k, whose band is exact)."""
    dev = geom.device
    start = _bucket_starts(nb, bucket0, dev)
    win = geom[24:48][:, start + torch.arange(BLOCK + bp_k, device=dev)]
    ext = [torch.abs(win[3 + 3 * c]) * win[12]
           + torch.abs(win[4 + 3 * c]) * win[13]
           + torch.abs(win[5 + 3 * c]) * win[14] for c in range(3)]
    mins = [win[c] - ext[c] for c in range(3)]
    maxs = [win[c] + ext[c] for c in range(3)]
    a = torch.arange(BLOCK, device=dev)
    d = torch.arange(1, bp_k + 1, device=dev)[:, None]
    b = a[None, :] + d                                    # [bp_k, 128]

    def at_a(x):
        return x[:, None, :BLOCK]                         # [NB, 1, 128]

    def at_b(x):
        return x[:, b]                                    # [NB, bp_k, 128]

    x_ov = at_b(mins[0]) <= at_a(maxs[0])
    keep = x_ov
    for c in range(3):
        keep = keep & (torch.maximum(at_a(mins[c]), at_b(mins[c]))
                       <= torch.minimum(at_a(maxs[c]), at_b(maxs[c])))
    live = (at_a(win[19]) > 0.0) & (at_b(win[19]) > 0.0)
    keep = keep & live & ((at_a(win[17]) > 0.0) | (at_b(win[17]) > 0.0))
    if env_k:
        keep = keep & ((a[None, :] % env_k) + d < env_k)
        winovf = torch.zeros((nb,), dtype=torch.int64, device=dev)
    else:
        winovf = (x_ov & live)[:, bp_k - 1].sum(dim=1)
    la = a[None, :].expand(bp_k, BLOCK).reshape(1, -1).to(torch.int32)
    lb = b.reshape(1, -1).to(torch.int32)
    la, lb, dropped = _compact_lanes(keep.reshape(nb, -1), la.expand(nb, -1),
                                     lb.expand(nb, -1), cap)
    return la, lb, dropped, winovf


def lane_geometry(geom: Tensor, loc: Tensor, bucket0: int = 0) -> Tensor:
    """The narrow-phase block (rows 24:48) of window-local ranks loc
    [NB, L] of the buckets from bucket0 on (bucket b's window starts at
    rank b·128; −1 = empty lane, read as zeros) → [24, NB, L]."""
    start = _bucket_starts(loc.shape[0], bucket0, geom.device)
    g = geom[24:48, start + torch.clamp(loc.to(torch.int64), min=0)]
    return torch.where((loc >= 0)[None], g, torch.zeros_like(g))


def obb_prefilter(ga, gb, la: Tensor, lb: Tensor, cap2: int, hulls: bool):
    """Both tables' prefilter: the 6 face axes of the two oriented boxes
    (boxes: the boxes themselves; hulls: their local AABBs, centred at
    rows 20:23) on every candidate lane; the overlapping lanes with a
    movable body (and two hulls) compacted, in order, into cap2 lanes.
    Returns (la, lb, dropped [NB])."""
    c = 20 if hulls else 0
    t = (gb[c] - ga[c], gb[c + 1] - ga[c + 1], gb[c + 2] - ga[c + 2])
    sep_best = _face_sat_sep(
        t, tuple(ga[3 + k] for k in range(9)),
        tuple(gb[3 + k] for k in range(9)),
        (ga[12], ga[13], ga[14]), (gb[12], gb[13], gb[14]))
    keep = ((sep_best < 0.0) & ((ga[17] > 0.0) | (gb[17] > 0.0))
            & (la >= 0))
    if hulls:
        keep = keep & (ga[19] > 0.0) & (gb[19] > 0.0)
    return _compact_lanes(keep, la, lb, cap2)


def _t_apply(g, w):
    """Rᵀ·w for the row-major rotation at g[3:12]."""
    return (g[3] * w[0] + g[6] * w[1] + g[9] * w[2],
            g[4] * w[0] + g[7] * w[1] + g[10] * w[2],
            g[5] * w[0] + g[8] * w[1] + g[11] * w[2])


def bucket_contact_table_plain(geom: Tensor, la: Tensor | None,
                               lb: Tensor | None, pcols: Tensor | None, *,
                               ccap: int, kk: int, kg: int, cap2: int,
                               ground_height: float, anchors: bool,
                               bucket0: int = 0, nb: int = 0, bp=None,
                               gate=None):
    """Plain version of the contact-table kernel, all buckets at once.

    geom [48, NPAD] unified table; la/lb [NB, cap] int32 window-local
    candidate ranks (−1 = empty lane) of the NB buckets from bucket0 on,
    or None with `bp = (bp_k, cap, env_k)`: the in-kernel broad phase of
    `nb` buckets (inkernel_candidates). pcols [NB·ccap, 8] previous-step
    key columns or None. `gate = (gate [NB] int32, persisted table [rows,
    NB·ccap])`: buckets whose gate is 0 take their persisted block and
    zero meta. Returns (table [rows, NB·ccap], meta [8, NB·128], warm
    [8, NB·ccap] or None)."""
    dev = geom.device
    rows_n = CT2_ROWS if anchors else CT_ROWS
    winovf = None
    dropped_bp = 0
    if bp is not None:
        la, lb, dropped_bp, winovf = inkernel_candidates(geom, nb, bucket0,
                                                         *bp)
    nb, cap = la.shape
    win = geom[24:48]
    start = _bucket_starts(nb, bucket0, dev)
    f32 = torch.float32

    ga, gb = lane_geometry(geom, la, bucket0), lane_geometry(geom, lb,
                                                             bucket0)
    dropped2 = torch.zeros((nb,), dtype=torch.int64, device=dev)
    if cap2:
        la, lb, dropped2 = obb_prefilter(ga, gb, la, lb, cap2, hulls=False)
        ga, gb = lane_geometry(geom, la, bucket0), lane_geometry(
            geom, lb, bucket0)
    # drops at either compaction (raw → cap, cap → cap2) add up
    dropped2 = dropped2 + dropped_bp

    man = box_box_manifold_batched(
        (ga[0], ga[1], ga[2]), tuple(ga[3 + k] for k in range(9)),
        (ga[12], ga[13], ga[14]),
        (gb[0], gb[1], gb[2]), tuple(gb[3 + k] for k in range(9)),
        (gb[12], gb[13], gb[14]))

    movable = (ga[17] > 0.0) | (gb[17] > 0.0)
    mu_p = torch.sqrt(ga[15] * gb[15])
    rest_p = torch.maximum(ga[16], gb[16])
    ia = ga[18].to(torch.int32)
    ib = gb[18].to(torch.int32)
    kl_p = torch.maximum(ia, ib).to(f32)
    kh_p = torch.minimum(ia, ib).to(f32)
    big_neg = torch.full_like(mu_p, _BIG_NEG)
    score = [torch.where(man.valid[s] & movable, man.depth[s], big_neg)
             for s in range(_CAP)]
    live = (la >= 0).to(f32)
    ra_p = (start + la).to(f32) * live
    rb1_p = (start + lb + 1).to(f32) * live

    rows = [[] for _ in range(rows_n)]

    def emit(vals, act, anc):
        af = act.to(f32)
        vals = vals[:9] + [af] + [v * af for v in vals[9:]]
        if anchors:
            vals += [v * af for v in anc]
            vals += [torch.zeros_like(af)] * (CT2_ROWS - 25)
        for r, v in enumerate(vals):
            rows[r].append(v)

    for _ in range(kk):
        best, bidx = _argmax_unrolled(score)
        act = best > 0.0
        pt = _select(bidx, man.points)
        anc = None
        if anchors:
            anc = (list(_t_apply(ga, v3.sub(pt, (ga[0], ga[1], ga[2]))))
                   + list(_t_apply(gb, v3.sub(pt, (gb[0], gb[1], gb[2]))))
                   + list(_t_apply(ga, man.normal)))
        emit([pt[0], pt[1], pt[2], man.normal[0], man.normal[1],
              man.normal[2], torch.where(act, best, torch.zeros_like(best)),
              mu_p, rest_p, kl_p, kh_p, torch.zeros_like(kl_p), ra_p,
              rb1_p, bidx.to(f32)], act, anc)
        score = [torch.where(bidx == s, big_neg, score[s])
                 for s in range(_CAP)]

    if kg > 0:
        gl = win[:, start[:, 0, None] + torch.arange(BLOCK, device=dev)]
        px, py, pz = gl[0], gl[1], gl[2]
        r9 = tuple(gl[3 + k] for k in range(9))
        hx, hy, hz = gl[12], gl[13], gl[14]
        mv = gl[17] > 0.0
        pts_g, dep_g = [], []
        for (sx, sy, sz) in _BOX_SIGNS:
            wx, wy, wz = sx * hx, sy * hy, sz * hz
            cx = px + r9[0] * wx + r9[1] * wy + r9[2] * wz
            cy = py + r9[3] * wx + r9[4] * wy + r9[5] * wz
            cz = pz + r9[6] * wx + r9[7] * wy + r9[8] * wz
            pts_g.append((cx, cy, cz))
            dep_g.append(ground_height - cy)
        big_g = torch.full_like(px, _BIG_NEG)
        gsc = [torch.where(mv & (d > 0.0), d, big_g) for d in dep_g]
        ra_g = (start + torch.arange(BLOCK, device=dev)).to(f32)
        one_g = torch.ones_like(px)
        zero_g = torch.zeros_like(px)
        for _ in range(kg):
            best, bidx = _argmax_unrolled(gsc)
            act = best > 0.0
            pt = _select(bidx, pts_g)
            anc = None
            if anchors:
                rel = v3.sub(pt, (gl[0], gl[1], gl[2]))
                anc = (list(_t_apply(gl, rel)) + [pt[0], pt[1], pt[2]]
                       + [gl[6], gl[7], gl[8]])
            emit([pt[0], pt[1], pt[2], zero_g, one_g, zero_g,
                  torch.where(act, best, zero_g), gl[15], gl[16],
                  gl[18], zero_g, one_g, ra_g, zero_g, bidx.to(f32)],
                 act, anc)
            gsc = [torch.where(bidx == s, big_g, gsc[s]) for s in range(8)]

    return compact_emissions(rows, ccap, dropped2, pcols, winovf, gate)


def compact_emissions(rows, ccap: int, dropped2: Tensor,
                      pcols: Tensor | None, winovf: Tensor | None = None,
                      gate=None):
    """The shared tail of both table kernels' plain versions. `rows[r]`
    lists the emissions' row-r values as [NB, L] tensors in emission
    order; the active ones take consecutive slots of their bucket (slots
    ≥ ccap are dropped and counted), then the meta counters (column 3
    `winovf`, or 0). `gate = (gate [NB], persisted table)` puts back the
    persisted block, with zero meta, of each bucket whose gate is 0.
    With `pcols`, each slot of the result takes its warm λ₀ from the
    previous contact of its bucket with the same feature key (a
    passed-through bucket matches its own keys). Returns (table [rows,
    NB·ccap], meta [8, NB·128], warm [8, NB·ccap] | None)."""
    pay = torch.stack([torch.cat(r, dim=1) for r in rows])  # [rows, NB, E]
    rows_n, nb = pay.shape[0], pay.shape[1]
    dev, f32 = pay.device, pay.dtype
    act = pay[CT_ACT] > 0.0
    slot = torch.cumsum(act.to(torch.int64), dim=1) - act.to(torch.int64)
    ok = act & (slot < ccap)
    idx = torch.where(ok, slot, torch.full_like(slot, ccap))
    out = torch.zeros((rows_n, nb, ccap + 1), dtype=f32, device=dev)
    out.scatter_(2, idx[None].expand(rows_n, -1, -1), pay)
    # contiguous also for one bucket, where the reshape below is a view
    out = out[:, :, :ccap].contiguous()

    n_act = act.sum(dim=1)
    meta = torch.zeros((8, nb, BLOCK), dtype=f32, device=dev)
    meta[0, :, 0] = torch.clamp(n_act - ccap, min=0).to(f32)
    meta[0, :, 1] = n_act.to(f32)
    meta[0, :, 2] = dropped2.to(f32)
    if winovf is not None:
        meta[0, :, 3] = winovf.to(f32)
    if gate is not None:
        fired = (gate[0] > 0)[None, :, None]
        out = torch.where(fired, out, gate[1].reshape(rows_n, nb, ccap))
        meta = torch.where(fired, meta, torch.zeros_like(meta))

    warm = None
    if pcols is not None:
        # fresh inactive slots key to (−2, 0) and previous inactive ones
        # to (−1, −1): never within 0.5 of each other or of a real key
        ck = (out[CT_KL] + 65536.0 * (2.0 * out[CT_KS] + out[CT_KSGN])
              + 2.0 * (out[CT_ACT] - 1.0))                 # [NB, ccap]
        ch = out[CT_KH]
        pc = pcols.reshape(nb, ccap, 8)
        eq = ((torch.abs(pc[:, :, 0, None] - ck[:, None, :]) < 0.5)
              & (torch.abs(pc[:, :, 1, None] - ch[:, None, :]) < 0.5))
        # keys are unique within a bucket: the first match is the match
        hit = eq.any(dim=1)                                # [NB, ccap]
        src = torch.argmax(eq.to(torch.uint8), dim=1)      # [NB, ccap]
        lam0 = torch.gather(pc[:, :, 4:7], 1,
                            src[:, :, None].expand(-1, -1, 3))
        lam0 = torch.where(hit[:, :, None], lam0, torch.zeros_like(lam0))
        warm = torch.zeros((8, nb, ccap), dtype=f32, device=dev)
        warm[0:3] = lam0.permute(2, 0, 1)
        warm = warm.reshape(8, nb * ccap)
    return (out.reshape(rows_n, nb * ccap), meta.reshape(8, nb * BLOCK),
            warm)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _launch_kernel(geom, la, lb, pcols, *, ccap, kk, kg, cap2,
                   ground_height, anchors, bucket0, nb, bp, gate):
    from physics_tpu_torch import _build

    dev = geom.device
    npad = geom.shape[1]
    rows_n = CT2_ROWS if anchors else CT_ROWS
    cp = nb * ccap
    bp_k, cap, env_k = bp if bp is not None else (0, la.shape[1], 0)
    i32, f32 = torch.int32, torch.float32
    named = [("geom", geom, f32, (48, npad))]
    if bp is None:
        named += [("la", la, i32, (nb, cap)), ("lb", lb, i32, (nb, cap))]
    if pcols is not None:
        named.append(("prev cols", pcols, f32, (cp, 8)))
    if gate is not None:
        named += [("gate", gate[0], i32, (nb,)),
                  ("persisted table", gate[1], f32, (rows_n, cp))]
    _build.check_operands("contact table", dev, *named)
    # the last bucket of the range reads ranks up to its start + 2·128
    if npad < (bucket0 + nb) * BLOCK + 2 * BLOCK:
        raise ValueError(f"contact table: NPAD {npad} too small for "
                         f"{bucket0 + nb} buckets")
    lib = _build.library()
    words = lib.ct_scratch_words(nb, cap, cap2, kk, kg, ccap)
    if words < 0:
        raise ValueError(f"contact table: {nb} buckets of {cap} lanes need "
                         f"more than 2³¹ words of scratch")
    table = torch.empty((rows_n, cp), dtype=f32, device=dev)
    meta = torch.empty((8, nb * BLOCK), dtype=f32, device=dev)
    warm = (torch.empty((8, cp), dtype=f32, device=dev)
            if pcols is not None else None)
    scratch = torch.empty((words,), dtype=i32, device=dev)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    with torch.cuda.device(dev):
        err = lib.ct_bucket_contact_table(
            ptr(geom), ptr(la), ptr(lb), ptr(pcols),
            ptr(gate[0] if gate is not None else None),
            ptr(gate[1] if gate is not None else None),
            ptr(table), ptr(meta), ptr(warm), ptr(scratch), words,
            nb, bucket0, cap, cap2, ccap, kk, kg, npad, rows_n, bp_k, env_k,
            ctypes.c_float(ground_height),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "ct_bucket_contact_table")
    bucket_contact_table.launches += 1
    return table, meta, warm


def table_operands(state: SimState, cand: PairCandidates | None,
                   cfg: SimConfig,
                   prev: Tuple[Tensor, Tensor] | Tensor | None,
                   geom: Tensor | None, what: str,
                   buckets: Tuple[int, int] | None = None,
                   plain: bool = False):
    """The checks and operands both table kernels share: la/lb [NB, cap]
    int32 window-local candidate ranks (−1 = empty lane), the previous
    step's key columns (or None), and the keywords ccap, cap2 (0 when the
    prefilter cap does not cut), ground_height, anchors, bucket0, nb and
    bp. `buckets = (bucket0, NB)` takes the candidates and previous keys
    of those NB buckets only (None: all buckets). `prev` is (keys, λ) of
    the previous step, whose columns prev_key_cols builds for CPU tensors
    (or `plain=True`) and table_prep's launch for CUDA tensors, or those
    columns already built (a gated refresh's refresh_prep).

    cand=None is the in-kernel broad phase: la = lb = None and bp =
    (bp_k, cap, env_k) with bp_k = min(band_window, 128, N − 1) and cap =
    min(the bucket cap, 128·bp_k) (env_k = env_block_size in packed-env
    mode, else 0); bp is None with candidates."""
    n = state.num_bodies
    if n > (1 << 16):
        raise ValueError(
            f"{what}: the stored feature keys pack body ids in 16 bits "
            f"(table_keys), so scenes above 65,536 bodies would alias warm "
            f"starts")
    block, cap, nb_cand = bucket_shape(n, cfg)
    nb, ccap, _ = table_shape(n, cfg)
    bp = None
    if cfg.broadphase == "env_blocks":
        env_k = cfg.env_block_size
        if cand is not None or not cfg.bp_inkernel:
            raise ValueError(f"{what}: env_blocks needs cfg.bp_inkernel "
                             f"(the same-env pairs are formed in the kernel)")
        if not (env_k > 1 and BLOCK % env_k == 0 and n % env_k == 0):
            raise ValueError(f"{what}: env_block_size {env_k} must divide "
                             f"{BLOCK} and num_bodies {n}")
    if cand is None:
        bp_k = min(band_window(cfg), BLOCK, n - 1)
        cap = min(cap, _round_up(BLOCK * bp_k, 128))
        bp = (bp_k, cap, cfg.env_block_size
              if cfg.broadphase == "env_blocks" else 0)
    elif block != BLOCK:
        raise ValueError(f"{what} requires bucket_block == {BLOCK} "
                         f"(got {block})")
    elif nb != nb_cand:
        raise ValueError(f"{what}: {nb} table buckets, {nb_cand} candidate "
                         f"buckets")
    bucket0, nb_l = buckets if buckets is not None else (0, nb)
    if not (0 <= bucket0 and nb_l >= 1 and bucket0 + nb_l <= nb):
        raise ValueError(f"{what}: bucket range {buckets} of {nb} buckets")
    if cand is not None and cand.mask.shape[0] != nb_l * cap:
        raise ValueError(f"{what}: {cand.mask.shape[0]} candidate lanes "
                         f"for {nb_l} buckets of {cap}")
    _, npad = geom_pad(n, cfg)
    if geom is None or geom.shape != (48, npad):
        raise ValueError(f"{what}: pass the unified geometry table "
                         f"[48, {npad}] (unified_geom)")
    cap2 = cfg.bucket_cap2
    if cap2:
        if cap2 % 128:
            raise ValueError(
                f"bucket_cap2 must be a 128-multiple; got {cap2}")
        # a cap2 at or above the bucket's lane count is no cut
        cap2 = min(cap2, cap)
        if cap2 == cap:
            cap2 = 0
    la = lb = None
    if cand is not None:
        base = _bucket_starts(nb_l, bucket0, geom.device).to(torch.int32)
        mask = cand.mask.reshape(nb_l, cap)
        la = torch.where(mask, cand.rank_a.reshape(nb_l, cap) - base,
                         -1).contiguous()
        lb = torch.where(mask, cand.rank_b.reshape(nb_l, cap) - base,
                         -1).contiguous()
    if prev is None or isinstance(prev, Tensor):
        pcols = prev
    elif plain or geom.device.type == "cpu":
        pcols = prev_key_cols(*prev)
    else:
        pcols = table_prep(*prev)[0]
    kw = dict(ccap=ccap, cap2=cap2, ground_height=float(cfg.ground_height),
              anchors=cfg.contact_rebuild > 1, bucket0=bucket0, nb=nb_l,
              bp=bp)
    return la, lb, pcols, kw


def bucket_contact_table(
    state: SimState,
    cand: PairCandidates | None,
    cfg: SimConfig,
    prev: Tuple[Tensor, Tensor] | Tensor | None = None,
    geom: Tensor | None = None,
    plain: bool = False,
    buckets: Tuple[int, int] | None = None,
    gate: Tuple[Tensor, Tensor] | None = None,
) -> Tuple[Tensor, Tensor, Tensor | None]:
    """The contact table of one rebuild. Returns (table [CT_ROWS or
    CT2_ROWS, NB·ccap], meta [8, NB·128], warm [8, NB·ccap] | None).
    `buckets = (bucket0, NB)` builds the NB buckets from bucket0 on (the
    row-sharded step: each rank its own range against the whole geometry
    table); `cand` and `prev` are then those buckets' slices, and the
    outputs are the range's [*, NB·ccap] and [8, NB·128] blocks.

    `cand=None` takes the in-kernel broad phase (cfg.bp_inkernel, the
    packed envs of broadphase="env_blocks", and the gated refresh; see
    inkernel_candidates) on `geom`'s rank order. `gate = (gate [NB] bool
    or int, persisted table [rows, NB·ccap])`: a bucket whose gate is 0
    keeps its persisted block and reports zero meta.

    meta[0, b·128 + 0] = contacts bucket b dropped beyond ccap,
    + 1 = its active contacts, + 2 = candidates dropped beyond the lanes
    (bucket_cap2, and the in-kernel broad phase's cap), + 3 = its ranks
    whose x-interval still overlaps at the in-kernel window's edge (0
    with candidates or packed envs). `prev = (keys [2, cp] int32, λ [3,
    cp])` of the previous step gives each slot its warm λ₀ (warm rows
    0:3) by matching keys within the same bucket; `prev` may also be their
    key columns [cp, 8], already built (table_operands). `geom` is the
    unified geometry table (unified_geom).

    A CPU tensor (or `plain=True`) runs the plain version; a CUDA
    tensor launches csrc/contact_table.cu.
    `launches` counts the calls that launched the kernel or recorded it
    into a CUDA graph being captured; a replay adds nothing."""
    la, lb, pcols, kw = table_operands(state, cand, cfg, prev, geom,
                                       "contact table", buckets, plain)
    kw["kk"] = min(cfg.max_contacts_per_pair, _CAP)
    kw["kg"] = min(cfg.max_contacts_per_pair, 8) if cfg.ground_plane else 0
    kw["gate"] = None if gate is None else (
        gate[0].to(torch.int32).contiguous(), gate[1])
    if plain or geom.device.type == "cpu":
        return bucket_contact_table_plain(geom, la, lb, pcols, **kw)
    if geom.device.type != "cuda":
        raise ValueError(f"contact table: unsupported device {geom.device}")
    return _launch_kernel(geom, la, lb, pcols, **kw)


bucket_contact_table.launches = 0
