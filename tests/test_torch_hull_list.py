"""The generic hull path's pair contacts (ops/hull_list.py
hull_pair_contacts; csrc/hull_list.cu on the card).

On the CPU: the wrapper runs the plain version (narrowphase.
_pair_contacts_hulls_fast) field for field, alone and inside the contact
list; the type-pair segments; the packed tables, cut at the kernel's
offsets, give the coefficient tables back. No JAX.

On the card (marked cuda; they skip without one): the two launches a
segment against the plain version at the 1,024-hull rain's shapes
(settled, and fresh: most lanes separated), on 256 bevelled cubes and on
the 3-type library (faces of 3 and 4 vertices, 9 segments): ids, keys
and activity identical, every f32 field bit for bit; masked, separated
and edge-contact lanes among them; the launch count rises by two a
segment, and a CUDA tensor never reaches the plain version.

    python -m pytest --noconftest tests/test_torch_hull_list.py
"""

import pytest
import torch

from physics_tpu_torch import scenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.ops import hull_list as hl
from physics_tpu_torch.ops import narrowphase as nph
from physics_tpu_torch.ops.broadphase import PairCandidates
from physics_tpu_torch.ops.hullhull_batched import (
    hull_tables,
    shared_hull_manifolds_sm,
)
from physics_tpu_torch.solver.contacts import banded_inputs, hull_contact_list

CASES = {"one_type": (48, 1), "three_types": (48, 3)}


def _scene(n, types, device, steps):
    cfg = scenes.rain_xla_config(n)
    if types == 1:
        s = scenes.mesh_rain(n, real_assets=False, device=device)
    else:
        s = scenes.mesh_rain_mixed(n, n_types=types, real_assets=False,
                                   device=device)
    s = prepare_contacts(s, cfg)
    for _ in range(steps):
        s, _ = step_with_metrics(s, cfg, plain=True)
    return s, cfg


def _lanes(s, cfg):
    """The prefiltered candidates the pair contacts run on."""
    _, _, cand, _, _ = banded_inputs(s, cfg, hulls=True)
    cand, _ = nph.hull_obb_prefilter(s, cand, cfg.hull_prefilter_cap)
    return cand


def _equal(a, b):
    for f in nph.Contacts._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.fixture(scope="module", params=list(CASES))
def cpu_scene(request):
    n, types = CASES[request.param]
    return _scene(n, types, "cpu", 4)


def test_cpu_wrapper_is_the_plain_version(cpu_scene):
    s, cfg = cpu_scene
    cand = _lanes(s, cfg)
    want = nph._pair_contacts_hulls_fast(s, cand, cfg)
    n0 = hl.hull_pair_contacts.launches
    _equal(hl.hull_pair_contacts(s, cand, cfg), want)
    _equal(hl.hull_pair_contacts(s, cand, cfg, plain=True), want)
    assert hl.hull_pair_contacts.launches == n0
    assert int(want.active.sum()) > 0


def test_cpu_contact_list_plain_switch(cpu_scene):
    s, cfg = cpu_scene
    got, ref = hull_contact_list(s, cfg), hull_contact_list(s, cfg,
                                                            plain=True)
    _equal(got.contacts, ref.contacts)
    for a, b in zip(got.ranks, ref.ranks):
        assert torch.equal(a, b)


def test_segments():
    s, cfg = _scene(48, 3, "cpu", 0)
    cand = _lanes(s, cfg)
    p = cand.body_a.shape[0]
    segs = nph.hull_segments(s, cand)
    assert segs == [(i * (p // 9), p // 9, (i // 3, i % 3))
                    for i in range(9)]
    s1, cfg1 = _scene(48, 1, "cpu", 0)
    cand1 = _lanes(s1, cfg1)
    assert nph.hull_segments(s1, cand1) == [(0, cand1.body_a.shape[0],
                                             (0, 0))]
    short = PairCandidates(*[x if x.dim() == 0 else x[:-1] for x in cand])
    with pytest.raises(ValueError, match="segmented"):
        nph.hull_segments(s, short)


@pytest.mark.parametrize("types", [(0, 0), (1, 2), (2, 0)])
def test_packed_tables_cut_at_the_kernels_offsets(types):
    """csrc/hull_list.cu `tables`: the f32 and int32 packs, cut in that
    order and at those sizes, are the coefficient tables."""
    s, _ = _scene(16, 3, "cpu", 0)
    ht = hull_tables(s.hulls, *types)
    ftab, itab, dims = hl.list_tables(s.hulls, *types)
    f, v, d2, e, e2 = dims
    sizes = {"a_fv": f * v * 9, "b_fv": f * v * 9, "c_av": d2 * v * 9,
             "c_bv": d2 * v * 9, "l_ax": d2 * 27, "ff": f * f * 9,
             "face_n_a": 3 * f, "face_n_b": 3 * f, "face_off_a": f,
             "face_off_b": f, "face_mask_a": f, "face_mask_b": f,
             "ax_mask": d2, "verts_a": 3 * v, "verts_b": 3 * v,
             "edge_mask_a": e2, "edge_mask_b": e2,
             "face_verts_a": f * e, "face_verts_b": f * e,
             "face_cnt_a": f, "face_cnt_b": f, "edge_i0_a": e2,
             "edge_i1_a": e2, "edge_i0_b": e2, "edge_i1_b": e2}
    for pack, fields in ((ftab, hl._F32_FIELDS), (itab, hl._I32_FIELDS)):
        at = 0
        for k in fields:
            want = getattr(ht, k).reshape(-1)
            assert want.numel() == sizes[k], k
            assert torch.equal(pack[at:at + sizes[k]], want.to(pack.dtype)), k
            at += sizes[k]
        assert at == pack.numel()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

GPU_CASES = {"rain1k_settled": (1024, 1, 60), "rain1k_fresh": (1024, 1, 0),
             "rain256": (256, 1, 20), "mixed128x3": (128, 3, 40)}


@pytest.fixture(scope="module", params=list(GPU_CASES))
def gpu_scene(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, types, steps = GPU_CASES[request.param]
    s, cfg = _scene(n, types, "cuda", steps)
    return request.param, s, cfg


def _lane_kinds(s, cand):
    """Over the segments' lanes: (masked, live separated, live with an
    active edge contact in the plain manifolds)."""
    masked = int((~cand.mask).sum())
    sep = edge = 0
    for lane0, p, types in nph.hull_segments(s, cand):
        sl = slice(lane0, lane0 + p)
        c = PairCandidates(cand.body_a[sl], cand.body_b[sl], cand.mask[sl],
                           cand.overflow, cand.rank_a[sl], cand.rank_b[sl])
        sm, separated = shared_hull_manifolds_sm(s, c, types,
                                                 with_separated=True)
        sep += int((c.mask & separated).sum())
        edge += int((c.mask & (sm.depth[-1] > 0)).sum())
    return masked, sep, edge


@pytest.mark.cuda
def test_kernel_matches_plain(gpu_scene):
    name, s, cfg = gpu_scene
    cand = _lanes(s, cfg)
    n0 = hl.hull_pair_contacts.launches
    got = hl.hull_pair_contacts(s, cand, cfg)
    segs = len(nph.hull_segments(s, cand))
    assert hl.hull_pair_contacts.launches == n0 + 2 * segs
    ref = hl.hull_pair_contacts(s, cand, cfg, plain=True)
    assert hl.hull_pair_contacts.launches == n0 + 2 * segs
    for f in ("body_a", "body_b", "key", "active"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in ("point", "normal", "depth", "friction", "restitution"):
        a, b = getattr(got, f), getattr(ref, f)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    masked, sep, edge = _lane_kinds(s, cand)
    assert masked > 0 and sep > 0
    if name != "rain1k_fresh":
        assert int(ref.active.sum()) > 50 and edge > 0


@pytest.mark.cuda
def test_cuda_never_takes_the_plain_version(gpu_scene, monkeypatch):
    _, s, cfg = gpu_scene

    def refuse(*a, **k):
        raise AssertionError("the plain pair contacts ran on the card")
    monkeypatch.setattr(hl, "_pair_contacts_hulls_fast", refuse)
    monkeypatch.setattr(nph, "_hull_fast_select_rows", refuse)
    n0 = hl.hull_pair_contacts.launches
    cl = hull_contact_list(s, cfg)
    assert hl.hull_pair_contacts.launches > n0
    assert int(cl.contacts.active.sum()) > 0 or GPU_CASES[gpu_scene[0]][2] == 0
