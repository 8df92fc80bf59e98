"""The generic hull path's pair contacts on the card: every type-pair
segment's SAT, manifold and kk slot picks in two launches of
csrc/hull_list.cu, written straight into the slot-major contact rows.

The plain version is ops/narrowphase.py `_pair_contacts_hulls_fast` (the
manifolds of ops/hullhull_batched.py `shared_hull_manifolds_sm` and the
picks of `_hull_fast_select_rows`), which the JAX package leaves to XLA's
glue (physics_tpu/ops/hullhull_batched.py, physics_tpu/ops/narrowphase.py);
no TPU kernel is replaced. The kernel decides every contact as the plain
version does on the card: each of its library products is summed in the
order cuBLAS and PyTorch's reductions take there (csrc/hull_list.cu).
cuBLAS picks its SGEMM kernel by shape, and two of its kernels sum a
[rows, 9] × [9, P] product in different orders (measured on an H100:
one fused multiply-add chain at the 1,024-hull rain's 4,096 lanes, three
chains of k 0–3, 4–7 and 8 at 56 lanes, and for the 243 axis rows at 455):
the first call at a lane count asks cuBLAS which (`split4`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from physics_tpu_torch import tracing
from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.ops.hullhull_batched import _mm, hull_tables
from physics_tpu_torch.ops.narrowphase import (
    Contacts,
    _pair_contacts_hulls_fast,
    hull_segments,
)
from physics_tpu_torch.state import SimState

MAX_FACE_VERTS = 32     # the kernel's clip holds 2E ≤ 64 polygon slots

_F32_FIELDS = ("a_fv", "b_fv", "c_av", "c_bv", "l_ax", "ff", "face_n_a",
               "face_n_b", "face_off_a", "face_off_b", "face_mask_a",
               "face_mask_b", "ax_mask", "verts_a", "verts_b", "edge_mask_a",
               "edge_mask_b")
_I32_FIELDS = ("face_verts_a", "face_verts_b", "face_cnt_a", "face_cnt_b",
               "edge_i0_a", "edge_i1_a", "edge_i0_b", "edge_i1_b")


def _pack(ht):
    """The type pair's tables as the kernel reads them: (f32 [*], int32
    [*], dims (F, V, D², E, E2))."""
    f32 = torch.cat([getattr(ht, k).reshape(-1).to(torch.float32)
                     for k in _F32_FIELDS]).contiguous()
    i32 = torch.cat([getattr(ht, k).reshape(-1).to(torch.int32)
                     for k in _I32_FIELDS]).contiguous()
    dims = (ht.face_n_a.shape[0], ht.verts_a.shape[0], ht.ax_mask.shape[0],
            ht.face_verts_a.shape[1], ht.edge_i0_a.shape[0])
    return f32, i32, dims


def list_tables(hulls, ia: int, ib: int):
    """_pack of type pair (ia, ib)'s tables, kept on the HullSet
    (HullSet.derived) as the tables themselves are."""
    return hulls.derived(("hull_list_tables", ia, ib),
                         lambda: _pack(hull_tables(hulls, ia, ib)))


@functools.cache
def split4(rows: int, p: int, device: torch.device) -> bool:
    """Whether cuBLAS sums a full-f32 [rows, 9] × [9, p] matmul on
    `device` as fused multiply-add chains over k 0–3, 4–7 and 8 added in
    turn (True) or as one chain over k (False): its product of two
    seeded operands at that shape against both orders emulated in f64
    (each step rounded to f32), on the first 64 rows. Reads back once a
    shape, so the first call comes before any capture (an eager step)."""
    g = torch.Generator().manual_seed(rows * 65537 + p)
    a = (torch.rand((rows, 9), generator=g) * 2 - 1).to(device)
    b = (torch.rand((9, p), generator=g) * 2 - 1).to(device)
    c = _mm(a, b)[:64]
    a64, b64 = a[:64].double(), b.double()

    def chain(ks):
        acc = torch.zeros_like(c)
        for k in ks:
            acc = (a64[:, k, None] * b64[k][None] + acc.double()).float()
        return acc
    one = chain(range(9))
    split = (chain(range(4)) + chain(range(4, 8))) + chain([8])
    return int((split != c).sum()) < int((one != c).sum())


def _orders(dims, p: int, device) -> int:
    """csrc/hull_list.cu's `orders` at p lanes: split4 of the face (1),
    axis-vertex (2) and axis (4) tables' products."""
    f, v, d2, _, _ = dims
    return sum(bit for bit, rows in ((1, f * v), (2, d2 * v), (4, d2 * 3))
               if split4(rows, p, device))


def _launch_kernel(state: SimState, cand: PairCandidates, cfg: SimConfig
                   ) -> Contacts:
    from physics_tpu_torch import _build

    dev = state.pos.device
    n = state.num_bodies
    p_tot = cand.body_a.shape[0]
    segs = hull_segments(state, cand)
    dims0 = list_tables(state.hulls, *segs[0][2])[2]
    e = dims0[3]
    if e > MAX_FACE_VERTS:
        raise ValueError(f"hull pair contacts: faces of up to "
                         f"{MAX_FACE_VERTS} vertices on the card (got {e})")
    ns = 2 * e + 1
    kk = min(cfg.max_contacts_per_pair, ns)
    has_key = int(n * n * ns < 2**31 - 1)
    sh = state.shapes
    i32, f32 = torch.int32, torch.float32
    ops = [("pos", state.pos, f32, (n, 3)), ("quat", state.quat, f32, (n, 4)),
           ("inv_mass", state.inv_mass, f32, (n,)),
           ("stype", sh.stype, i32, (n,)),
           ("friction", sh.friction, f32, (n,)),
           ("restitution", sh.restitution, f32, (n,)),
           ("body_a", cand.body_a, i32, (p_tot,)),
           ("body_b", cand.body_b, i32, (p_tot,)),
           ("mask", cand.mask, torch.bool, (p_tot,))]
    _build.check_operands("hull pair contacts", dev, *ops)
    c = kk * p_tot
    point = torch.empty((3, c), dtype=f32, device=dev)
    normal = torch.empty((3, c), dtype=f32, device=dev)
    depth = torch.empty((c,), dtype=f32, device=dev)
    active = torch.empty((c,), dtype=torch.bool, device=dev)
    fric = torch.empty((c,), dtype=f32, device=dev)
    rest = torch.empty((c,), dtype=f32, device=dev)
    key = torch.empty((c,), dtype=i32, device=dev)
    ia_out = torch.empty((c,), dtype=i32, device=dev)
    ib_out = torch.empty((c,), dtype=i32, device=dev)
    sink = tracing.slots("list_sat_lanes", 2)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)
    tracing.stage("list_manifolds", dev)
    with torch.cuda.device(dev):
        for lane0, p, types in segs:
            ftab, itab, dims = list_tables(state.hulls, *types)
            f, _, d2, _, _ = dims
            orders = _orders(dims, p, dev)
            sep = torch.empty(((2 * f + d2) * p,), dtype=f32, device=dev)
            err = lib.hl_pair_contacts(
                *[ptr(x) for _, x, _, _ in ops], ptr(ftab), ftab.numel(),
                ptr(itab), itab.numel(), ptr(sep), ptr(point), ptr(normal), ptr(depth), ptr(active),
                ptr(fric), ptr(rest), ptr(key), ptr(ia_out), ptr(ib_out),
                ptr(sink), n, lane0, p, p_tot, *dims, kk, has_key, orders,
                ctypes.c_void_p(stream))
            _build.check(err, "hl_pair_contacts")
            hull_pair_contacts.launches += 2
    return Contacts(body_a=ia_out, body_b=ib_out, point=point, normal=normal,
                    depth=depth, active=active, friction=fric,
                    restitution=rest, key=key)


def hull_pair_contacts(state: SimState, cand: PairCandidates,
                       cfg: SimConfig, plain: bool = False) -> Contacts:
    """Slot-major [kk·P] pair contacts of the generic hull path (the
    contract of narrowphase._pair_contacts_hulls_fast): one hull type, or
    hull_obb_prefilter's type-pair segments, each from its own tables.

    While tracing is on inside tracing.counting, both versions add the
    lanes with cand.mask and those whose SAT finds the hulls overlapping
    to the counters list_sat_lanes and list_sat_pass (tracing.slots);
    otherwise they count nothing.

    A CPU tensor (or `plain=True`) runs the plain version; a CUDA tensor
    launches csrc/hull_list.cu, two launches a segment (list_sat_kernel,
    list_picks_kernel), and reads nothing back to the host once each lane
    count's sum orders are known (split4: the first call at a lane count
    reads back, so an eager step comes before a capture, as
    engine.DeviceStepper's warm-up step does).
    `launches` counts the launches made or recorded into a CUDA graph
    being captured; a replay adds nothing."""
    if plain or state.pos.device.type == "cpu":
        return _pair_contacts_hulls_fast(state, cand, cfg)
    if state.pos.device.type != "cuda":
        raise ValueError(f"hull pair contacts: unsupported device "
                         f"{state.pos.device}")
    return _launch_kernel(state, cand, cfg)


hull_pair_contacts.launches = 0
