"""The hull contact table on libraries whose largest face is not a
quadrilateral: physics_tpu_torch's plain version (the CPU side of kernel
csrc/hull_table.cu, built for faces of up to 16 vertices) against the
JAX package's Pallas kernel in interpret mode, on one bucket of 48
hexagonal bipyramids (12 triangles, E = 3) and of 48 truncated octahedra
(8 hexagons and 6 squares, E = 6), squeezed into contact and stepped
twice by the port so the warm keys are live; and the port's hull_rain
scene against the same rain built by the JAX package's SceneBuilder.
(The JAX kernel reduces vertices 8 at a time, so its libraries keep a
vertex capacity that is a multiple of 8: 8 and 24 here. The GPU tests
hold the kernel to the plain version on octahedra and prisms too.)

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


VERTS = {3: _bipyramid(), 6: _truncated_octahedron()}


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


@pytest.mark.parametrize("e", [3, 6])
def test_hull_rain_scene_matches(e):
    ja = jax_arrays(jax_hull_rain(VERTS[e], N))
    ta = to_numpy(tscenes.hull_rain(VERTS[e], N, device="cpu"))
    assert sorted(ta) == sorted(ja)
    for key in ja:
        assert np.array_equal(ta[key], ja[key]), key
    assert ta["hulls.face_verts"].shape[2] == e


@pytest.mark.parametrize("e", [3, 6])
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
