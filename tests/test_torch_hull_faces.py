"""The hull contact table on libraries whose largest face is not a
quadrilateral: physics_tpu_torch's plain version (the CPU side of kernel
csrc/hull_table.cu, built for faces of up to 64 vertices) against the
JAX package's Pallas kernel in interpret mode, on one bucket of 48
hexagonal bipyramids (12 triangles, E = 3), of 48 truncated octahedra
(8 hexagons and 6 squares, E = 6) and of 48 prisms over a 20-gon (E =
20, above the 16 vertices the kernel holds in registers), squeezed into
contact and stepped twice by the port so the warm keys are live; the
port's hull_rain scene against the same rain built by the JAX package's
SceneBuilder; and the plain clip's scatter against the one-hot sum it
replaced, bit for bit. (The JAX kernel reduces vertices 8 at a time, so
its libraries keep a vertex capacity that is a multiple of 8: 8, 24 and
40 here. The GPU tests hold the kernel to the plain version on
octahedra and prisms of up to 63 sides too.)

Tolerances as tests/test_torch_hull_table.py: geometry and previous
impulses rounded to 16 significant bits; keys, activity, ranks, slot
ids, friction, restitution, meta and warm rows identical; f32 rows
within 4·2⁻¹⁷ × the scene extent.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from physics_tpu.io.meshes import box_inertia
from physics_tpu.ops import broadphase as jbp
from physics_tpu.ops import contact_table as jct
from physics_tpu.ops import hull_table as jht
from physics_tpu.scene import SceneBuilder
from physics_tpu_torch import scenes as tscenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.io.primitives import prism_verts
from physics_tpu_torch.ops import boxbox_batched as tbb
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops import hull_table as tht
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.state import state_from_arrays, to_numpy

from tests.test_torch_config_scene import bf16_pair_exact, jax_arrays
from tests.test_torch_hull_table import jax_state_like

EXACT_ROWS = [tct.CT_ACT, tct.CT_KL, tct.CT_KH, tct.CT_KSGN, tct.CT_RA,
              tct.CT_RB1, tct.CT_KS, tct.CT_MU, tct.CT_REST]
N = 48


def _bipyramid(sides=6, radius=0.5, half_height=0.5):
    ang = 2.0 * np.pi * np.arange(sides) / sides
    ring = [[radius * np.cos(a), 0.0, radius * np.sin(a)] for a in ang]
    return np.asarray(ring + [[0, half_height, 0], [0, -half_height, 0]],
                      np.float32)


def _truncated_octahedron(size=0.5):
    pts = set()
    for p in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
              (2, 1, 0)):
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    pts.add((sx * p[0], sy * p[1], sz * p[2]))
    return np.asarray(sorted(pts), np.float32) * (size / 2)


VERTS = {3: _bipyramid(), 6: _truncated_octahedron(), 20: prism_verts(20)}


def jax_hull_rain(verts, n, seed=0, size=0.5):
    """scenes.hull_rain built by the JAX package (mesh_rain's column)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    hull = b.add_hull(np.asarray(verts, np.float32))
    side = max(1, int(np.ceil(np.sqrt(n / 4))))
    count, layer = 0, 0
    while count < n:
        for gx in range(side):
            for gz in range(side):
                if count >= n:
                    break
                jitter = rng.uniform(-0.2, 0.2, 3)
                i = b.add_body(
                    pos=((gx - side / 2) * 2.5 * size + jitter[0],
                         1.5 * size + layer * 3.0 * size + jitter[1],
                         (gz - side / 2) * 2.5 * size + jitter[2]),
                    euler=rng.uniform(-1.5, 1.5, 3),
                    inertia=box_inertia((size,) * 3, 1.0))
                b.set_hull(i, hull, friction=0.4, restitution=0.05)
                count += 1
        layer += 1
    return b.build()


@pytest.mark.parametrize("e", [3, 6, 20])
def test_hull_rain_scene_matches(e):
    ja = jax_arrays(jax_hull_rain(VERTS[e], N))
    ta = to_numpy(tscenes.hull_rain(VERTS[e], N, device="cpu"))
    assert sorted(ta) == sorted(ja)
    for key in ja:
        assert np.array_equal(ta[key], ja[key]), key
    assert ta["hulls.face_verts"].shape[2] == e


@pytest.mark.parametrize("e", [3, 6, 20])
def test_hull_table_face_size(e):
    js = jax_hull_rain(VERTS[e], N)
    arrays = jax_arrays(js)
    arrays["pos"] = arrays["pos"] * np.float32([0.55, 0.45, 0.55])
    arrays["pos"][:, 1] += 0.3
    over = dict(bucket_cap2=256, contact_rebuild=1, contact_refresh_iters=0)
    cfg_t = tscenes.rain_config(N).replace(**over)
    ts = prepare_contacts(state_from_arrays(arrays, "cpu"), cfg_t)
    for _ in range(2):
        ts, _ = step_with_metrics(ts, cfg_t)
    arrays = to_numpy(ts)
    arrays["contact_lam"] = bf16_pair_exact(arrays["contact_lam"])
    js = jax_state_like(js, arrays)
    ts = state_from_arrays(arrays, "cpu")
    from physics_tpu import scenes as jscenes
    cfg_j = jscenes.rain_config(N).replace(z_bf16=False, **over)

    order = jbp.sweep_order(js, jbp.body_aabbs(js))
    cand = jbp.pair_candidates(js, cfg_j)
    geom = bf16_pair_exact(jct.unified_geom(js, cfg_j, order, hulls=True))
    jt, jm, jw = map(np.asarray, jax.jit(
        lambda c, g, pk, pl: jht.bucket_hull_contact_table(
            js, c, cfg_j, order, prev=(pk, pl), geom=g))(
        cand, jnp.asarray(geom), js.contact_key, js.contact_lam))
    tc = PairCandidates(*[torch.from_numpy(np.array(x)) for x in cand])
    tt, tm, tw = [x.numpy() for x in tht.bucket_hull_contact_table(
        ts, tc, cfg_t, prev=(ts.contact_key, ts.contact_lam),
        geom=torch.from_numpy(geom))]
    act = jt[tct.CT_ACT]
    assert (act * (1 - jt[tct.CT_KSGN])).sum() > 20        # pair contacts
    assert jt[tct.CT_KS].max() <= 2 * e                     # slot ids < 2E + 1
    for r in EXACT_ROWS:
        assert np.array_equal(tt[r], jt[r]), r
    assert np.array_equal(tm, jm)
    np.testing.assert_array_equal(tw, jw)
    extent = float(np.abs(geom[0:3, :N]).max())
    np.testing.assert_allclose(tt, jt, rtol=0, atol=4 * 2.0 ** -17 * extent)


def _clip_one_hot(pu, pv, ps, m, cu, cv, d):
    """The plain clip as the port first wrote it: every output slot the
    sum over the inputs of the one placed there (the reference's one-hot
    form)."""
    cap = pu.shape[0]
    slots = torch.arange(cap, dtype=torch.int32).reshape(cap, 1)
    g = cu * pu + cv * pv - d[None]
    live = slots < m[None]
    wrap = (slots + 1) == m[None]

    def nxt(x):
        return torch.where(wrap, x[0][None], torch.roll(x, -1, dims=0))

    g_nxt = nxt(g)
    inside = (g <= 0.0) & live
    crossing = ((g <= 0.0) != (g_nxt <= 0.0)) & live
    denom = g - g_nxt
    t = torch.where(torch.abs(denom) > 1e-12, g / denom, torch.zeros_like(g))
    src = [(pu, pu + t * (nxt(pu) - pu)), (pv, pv + t * (nxt(pv) - pv)),
           (ps, ps + t * (nxt(ps) - ps))]
    inside_i = inside.to(torch.int32)
    emit = inside_i + crossing.to(torch.int32)
    start = torch.cumsum(emit, dim=0) - emit
    pos_cur = torch.where(inside, start, torch.full_like(start, cap))
    pos_int = torch.where(crossing, start + inside_i,
                          torch.full_like(start, cap))
    zero = torch.zeros_like(pu[0])
    out = []
    for cur, inter in src:
        rows = []
        for j in range(cap):
            a = zero
            for i in range(cap):
                a = a + torch.where(pos_cur[i] == j, cur[i], zero) + \
                    torch.where(pos_int[i] == j, inter[i], zero)
            rows.append(a)
        out.append(torch.stack(rows))
    new_m = torch.clamp(torch.sum(emit, dim=0), max=cap).to(torch.int32)
    return (*out, new_m)


@pytest.mark.parametrize("e", [4, 20])
def test_clip_scatter_is_the_one_hot_sum(e):
    """Random polygons of up to E vertices in 2E slots (signed zeros,
    points on the line, full and empty clips), through E successive
    clips: every slot's bits and the counts equal."""
    rng = np.random.default_rng(e)
    p = 64
    cap = 2 * e
    pts = rng.normal(0, 1, (3, cap, p)).astype(np.float32)
    pts[:, e:] = 0.0
    pts[0, 0, :8] = -0.0
    pts[:, 1, 8:16] = 0.0
    pu, pv, ps = (torch.from_numpy(x) for x in pts)
    m = torch.from_numpy(rng.integers(0, e + 1, p).astype(np.int32))
    a, b = (pu, pv, ps, m), (pu, pv, ps, m)
    for k in range(e):
        ang = 2 * np.pi * k / e
        cu, cv = float(np.cos(ang)), float(np.sin(ang))
        d = torch.from_numpy(rng.uniform(-0.5, 1.5, p).astype(np.float32))
        d[:4] = 0.0
        a = tbb._clip(*a, cu, cv, d)
        b = _clip_one_hot(*b, cu, cv, d)
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), k
    assert int(a[3].max()) > 2
