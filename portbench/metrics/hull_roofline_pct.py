"""hull_roofline_pct (layer: hull contact table): the least time of the
hull contact table (2.4) over the traced calls, counted from each
rebuild's inputs by the bound below, as a share of the device time of
2.4's seven kernels in the trace (hull_prefilter, hull_sat,
hull_manifold, hull_ground, hull_scan, hull_rows and the warm match of
the hull table).

The bound is a frozen copy of chip_smoke.py's 2.4 bound (hull_table_ops,
its sat_lanes for hulls and table_bytes with the hull library), taking
the reference's tensors of a step (reference/hull_step.py's on_step) in
place of the program's; the peaks and the prefilter's and emission's
operations are core/yardstick.py's."""

import re

import torch

from portbench.core import trace
from portbench.core.yardstick import OPS_EMIT, OPS_OBB_PREFILTER, bound, nbytes
from portbench.reference.hull_table import (
    hull_dims,
    hull_obb_prefilter,
    hull_operands,
)
from portbench.reference.table import CT_ACT, lane_geometry

KERNELS = re.compile(
    r"(?<![A-Za-z_])hull_(prefilter|sat|manifold|ground|scan|rows)_kernel"
    r"|warm_match_kernel<[^>]*hull_table_warm")
LIBRARY = ("verts", "vert_count", "face_normals", "face_offsets",
           "face_count", "face_verts", "face_vert_count", "edge_dirs",
           "edge_dir_count", "edge_i0", "edge_i1", "edge_count")


def sat_lanes(st, cfg, s):
    """(live candidate lanes, the two [24, L] lane geometries the SAT
    runs on): the prefilter's survivors, at most bucket_cap2 a bucket,
    of two hulls with one movable."""
    la, lb, _, _, kw = hull_operands(st, s["cand"], cfg, None, s["geom"])
    ga, gb = lane_geometry(s["geom"], la), lane_geometry(s["geom"], lb)
    if kw["cap2"]:
        la, lb, _ = hull_obb_prefilter(ga, gb, la, lb, kw["cap2"])
        ga, gb = lane_geometry(s["geom"], la), lane_geometry(s["geom"], lb)
    keep = ((la >= 0) & ((ga[17] > 0) | (gb[17] > 0)) & (ga[19] > 0)
            & (gb[19] > 0))
    return int(s["cand"].mask.sum()), ga[:, keep], gb[:, keep]


def hull_table_ops(st, cfg, s, act: int) -> float:
    """The f32 operations of the function on these inputs (chip_smoke.py
    hull_table_ops): per SAT lane of type pair (a, b) the vertices into
    the other frame, the face separations, the edge axes with their
    supports, then the incident face, the polygons, E clips of 2E slots,
    the edge-edge point and kk picks; the prefilter per live candidate
    lane; the kg lowest vertices of each hull; each active contact's
    emission."""
    hs = st.hulls
    e = hull_dims(hs).e
    vcap = hs.verts.shape[1]
    live, ga, gb = sat_lanes(st, cfg, s)
    ta, tb = (ga[19] - 1).long(), (gb[19] - 1).long()
    f, v = hs.face_count.double(), hs.vert_count.double()
    d, e2 = hs.edge_dir_count.double(), hs.edge_count.double()
    fa, fb, va, vb = f[ta], f[tb], v[ta], v[tb]
    sat = (75 + 18 * (va + vb) + 6 * (fa * vb + fb * va) + 2 * (fa + fb)
           + 15 * d[tb] + d[ta] * d[tb] * (31 + 7 * (va + vb)))
    manifold = (6 * torch.minimum(fa, fb) + 36 * e + 21 + 30 + 26 * e
                + e * 2 * e * 19 + 3 * (e2[ta] + e2[tb]) + 7 * (va + vb)
                + 132 + 56 * min(cfg.max_contacts_per_pair, 2 * e + 1))
    kg = min(cfg.max_contacts_per_pair, 8, vcap)
    vr = v[torch.clamp(st.shapes.hull_index, 0).long()]
    return (OPS_OBB_PREFILTER * live + float((sat + manifold).sum())
            + float(((6 + kg) * vr).sum()) + OPS_EMIT * act)


def least(st, cfg, s):
    """2.4's least time on a rebuild's inputs: the narrow-phase rows of
    the geometry table for the scene's ranks, the candidate lanes, the
    previous keys and impulses and the hull library read once; the
    table, meta and warm rows written."""
    if s.get("table_call") is None or s.get("cand") is None:
        return None
    table = s["table_call"][0]
    act = int((table[CT_ACT] > 0).sum())
    n = st.num_bodies
    moved = nbytes(s["geom"][24:48, :n], s["cand"].rank_a,
                   s["cand"].rank_b, *s["prev"], *s["table_call"],
                   *[getattr(st.hulls, k) for k in LIBRARY])
    return bound(moved, hull_table_ops(st, cfg, s, act))


def read(ctx):
    us = trace.group_us(ctx.trace, KERNELS)
    if ctx.least is None or us is None:
        return None
    return 100.0 * 1e3 * ctx.least / us
