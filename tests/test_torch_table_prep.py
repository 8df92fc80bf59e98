"""The contact table's operands built before it (ops/contact_table.py
table_prep, csrc/table_prep.cu; solver/contacts.py refresh_prep): the
displacement gate of a gated refresh, contact_ref reset for the fired
buckets' bodies, and the previous keys' [C, 8] columns.

On the CPU refresh_prep and table_operands take the plain versions,
refresh_gate, prev_key_cols and fired_ref, and launch nothing: the same
gate, bits and columns as refresh_gate, the parent's tail of
_gated_refresh (copied below) and prev_key_cols, on packed states and
on states with a sweep order, with a ragged last bucket, with each
bucket's largest displacement placed below, on, one ulp either side of
and far above the threshold, and with a NaN pose; a model of the
kernel's blocks (a bucket and the next one's ranks, 256 at a time)
gives the same gate and rows. table_operands reads the sharded table's
bucket range of the previous keys, and passes built columns through.
The contact table from built columns equals the one from (keys, λ).
table_prep refuses CPU tensors: no fallback.

The tests marked `cuda` skip without a card. On one they hold the
kernel to the plain versions bit for bit (the gate as 0/1, contact_ref
and the columns as int32 views: torch.equal counts −0 equal to +0) at
the benchmark scenes' shapes (4,096 packed envs of 8, the 4k pile with
its sweep order, the 1,024-hull rain's columns), on 4,097 bodies, on
the sharded range's strided views, and under CUDA graph replay, and
count one launch a call. On a GPU machine:

    python -m pytest --noconftest tests/test_torch_table_prep.py

This module imports no JAX.
"""

import numpy as np
import pytest
import torch

from physics_tpu_torch import scenes
from physics_tpu_torch.engine import prepare_contacts, step_with_metrics
from physics_tpu_torch.ops import contact_table as tct
from physics_tpu_torch.ops.broadphase import body_aabbs, sweep_order
from physics_tpu_torch.solver import contacts as tc

BLOCK = tct.BLOCK

# each bucket's largest displacement against the threshold thr, by mode:
# (x displacement as a function of thr in f32, or None; fires alone)
MODES = {
    "below": (lambda t: None, False),
    "tie": (lambda t: t, False),
    "ulp_above": (lambda t: np.nextafter(t, np.float32(np.inf)), True),
    "ulp_below": (lambda t: np.nextafter(t, np.float32(0.0)), False),
    "far": (lambda t: np.float32(3.0) * t, True),
    "turned": (lambda t: None, True),
}


def _thr(cfg):
    return np.float32(cfg.contact_rebuild_vel_factor * cfg.penetration_slop)


def _scene(kind, device="cpu"):
    """(state, cfg with the gate on, rank order or None) of each kind."""
    if kind in ("packed", "ragged"):
        n_env = 96 if kind == "packed" else 90      # 768 or 720 bodies
        return (scenes.packed_envs(n_env, 8, device=device),
                scenes.packed_env_config(n_env, 8), None)
    n = 700 if kind == "sorted" else 640
    s = scenes.box_pile(n, x_aspect=4.0, device=device)
    cfg = scenes.pile_config(n).replace(contact_rebuild_vel_factor=2.0)
    return s, cfg, sweep_order(s, body_aabbs(s))


def _displaced(s, cfg, order, modes, seed=0, nan=False):
    """s with contact_ref set so that each bucket's displacements are
    small (below thr, some turned) but for one rank of the bucket, whose
    displacement is its mode's; random previous keys (a third inactive)
    and λ of the table's shape."""
    rng = np.random.default_rng(seed)
    n = s.num_bodies
    nb, _, cp = tct.table_shape(n, cfg)
    thr = _thr(cfg)
    pos = s.pos.cpu().numpy().astype(np.float32)
    quat = s.quat.cpu().numpy().astype(np.float32)
    r_max = max(float(s.shapes.params.norm(dim=1).max()), 1e-3)
    ref_pos = (pos + rng.uniform(-0.2, 0.2, (n, 3)) * thr).astype(np.float32)
    ref_q = (quat + rng.uniform(-0.05, 0.05, (n, 4)) * thr / r_max).astype(
        np.float32)
    rank_body = (np.arange(n) if order is None
                 else order.cpu().numpy().astype(np.int64))
    names = list(modes)
    for b in range(nb):
        mode = names[b % len(names)]
        r = b * BLOCK + int(rng.integers(0, min(BLOCK, n - b * BLOCK)))
        i = rank_body[r]
        dx = MODES[mode][0](thr)
        if dx is not None:              # a translation along x alone
            ref_pos[i] = 0.0
            pos[i] = (dx, 0.0, 0.0)
            ref_q[i] = quat[i]
        elif mode == "turned":
            ref_q[i] = quat[i] + np.float32(0.3)
    if nan:
        pos[rank_body[min(BLOCK + 3, n - 1)], 1] = np.nan
    keys = np.stack([rng.integers(1, 1 << 20, cp), rng.integers(1, 65537, cp)])
    keys[:, rng.random(cp) < 0.33] = 0
    dev = s.device

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)
    return s.replace(
        pos=t(pos), contact_ref=t(np.concatenate([ref_pos, ref_q], axis=1)),
        contact_key=t(keys, torch.int32),
        contact_lam=t(rng.normal(0.0, 1.0, (3, cp))))


def _parent_tail(st, gate, order):
    """contact_ref as the gated refresh reset it before refresh_prep."""
    n = st.num_bodies
    if order is None:
        fired = gate.repeat_interleave(BLOCK)[:n]
    else:
        rank_of = torch.empty((n,), dtype=torch.int64, device=st.device)
        rank_of[order.long()] = torch.arange(n, device=st.device)
        fired = gate[rank_of // BLOCK]
    return torch.where(fired[:, None], torch.cat([st.pos, st.quat], dim=1),
                       st.contact_ref)


def _disp(st):
    """refresh_gate's per-body displacement."""
    ref = st.contact_ref
    dp = torch.amax(torch.abs(st.pos - ref[:, 0:3]), dim=1)
    dq2 = torch.minimum(torch.sum((st.quat - ref[:, 3:7]) ** 2, dim=1),
                        torch.sum((st.quat + ref[:, 3:7]) ** 2, dim=1))
    r_body = torch.sqrt(torch.sum(st.shapes.params ** 2, dim=1))
    return dp + 2.0 * torch.sqrt(dq2) * r_body


def _kernel_model(st, cfg, order):
    """The kernel's blocks on the CPU: block b takes ranks [128·b,
    128·b + 256) (0 past n), fires on their max (NaN carried) above thr,
    and writes its bucket's bodies' rows of contact_ref."""
    n = st.num_bodies
    nb = tct.table_shape(n, cfg)[0]
    disp = _disp(st).numpy()
    rank_body = np.arange(n) if order is None else order.numpy()
    padded = np.zeros(nb * BLOCK + BLOCK, np.float32)
    padded[:n] = disp[rank_body]
    gate = np.array([np.max(padded[b * BLOCK:b * BLOCK + 2 * BLOCK])
                     > _thr(cfg) for b in range(nb)])
    pose = torch.cat([st.pos, st.quat], dim=1).numpy()
    ref = st.contact_ref.numpy().copy()
    for r in range(n):
        if gate[r // BLOCK]:
            ref[rank_body[r]] = pose[rank_body[r]]
    return gate, ref


def _expected_gate(nb, modes):
    names = list(modes)
    fires = [MODES[names[b % len(names)]][1] for b in range(nb)] + [False]
    return [fires[b] or fires[b + 1] for b in range(nb)]


def _bits(x):
    return x.contiguous().view(torch.int32)


CASES = {
    "packed": ("packed", list(MODES)),
    "ragged": ("ragged", ["ulp_above", "tie", "below", "far", "ulp_below",
                          "turned"]),
    "sorted": ("sorted", ["tie", "ulp_below", "below", "turned",
                          "ulp_above", "far"]),
    "sorted_ties": ("sorted_even", ["tie", "ulp_below", "tie", "below",
                                    "tie"]),
}


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_refresh_prep_plain_route(case, nan):
    kind, modes = CASES[case]
    s, cfg, order = _scene(kind)
    st = _displaced(s, cfg, order, modes, seed=len(case), nan=nan)
    n0 = tct.table_prep.launches
    gate_ref = tc.refresh_gate(st, cfg, order)
    for plain in (False, True):
        gate, cols, ref = tc.refresh_prep(st, cfg, order, plain=plain)
        assert gate.dtype == torch.bool and torch.equal(gate, gate_ref)
        assert torch.equal(_bits(cols), _bits(tct.prev_key_cols(
            st.contact_key, st.contact_lam)))
        assert torch.equal(_bits(ref), _bits(_parent_tail(st, gate, order)))
    assert tct.table_prep.launches == n0
    model_gate, model_ref = _kernel_model(st, cfg, order)
    assert gate.tolist() == model_gate.tolist()
    assert torch.equal(_bits(ref), _bits(torch.from_numpy(model_ref)))
    nb = tct.table_shape(st.num_bodies, cfg)[0]
    if nan:
        # the NaN body's bucket and the one before never fire
        assert not gate[0] and not gate[1]
    else:
        assert gate.tolist() == _expected_gate(nb, modes)


def test_tie_never_fires():
    """A bucket whose largest displacement is the f32 threshold itself,
    beside buckets below it, does not fire; one ulp above does."""
    s, cfg, order = _scene("sorted_even")
    for modes, want in ((["tie", "below", "below", "below", "below"], 0),
                        (["below", "ulp_above", "below", "below", "below"],
                         2)):
        st = _displaced(s, cfg, order, modes, seed=5)
        gate, _, _ = tc.refresh_prep(st, cfg, order)
        assert int(gate.sum()) == want


@pytest.mark.parametrize("buckets", [None, (1, 2), (3, 2)])
def test_table_operands_columns(buckets):
    """The previous keys' columns of a bucket range, from the sharded
    table's slices of (keys, λ) along dim 1, are the whole columns'
    rows of the range; built columns pass through."""
    s, cfg, _ = _scene("packed")
    st = _displaced(s, cfg, None, ["below"], seed=9)
    nb, ccap, _ = tct.table_shape(st.num_bodies, cfg)
    geom = tct.unified_geom(st, cfg, None)
    whole = tct.prev_key_cols(st.contact_key, st.contact_lam)
    b0, nb_l = buckets if buckets is not None else (0, nb)
    prev = (st.contact_key.narrow(1, b0 * ccap, nb_l * ccap),
            st.contact_lam.narrow(1, b0 * ccap, nb_l * ccap))
    for plain in (False, True):
        _, _, pcols, _ = tct.table_operands(st, None, cfg, prev, geom, "t",
                                            buckets, plain)
        assert torch.equal(_bits(pcols),
                           _bits(whole[b0 * ccap:(b0 + nb_l) * ccap]))
    _, _, same, _ = tct.table_operands(st, None, cfg, whole, geom, "t")
    assert same is whole


def test_gated_table_from_built_columns():
    """The gated refresh's contact table from refresh_prep's columns
    equals the table from (keys, λ), on 32 packed envs stepped twice."""
    cfg = scenes.packed_env_config(32, 8)
    s = prepare_contacts(scenes.packed_envs(32, 8, device="cpu"), cfg)
    for _ in range(2):
        s, _ = step_with_metrics(s, cfg)
    geom = tct.unified_geom(s, cfg, None)
    gate, cols, _ = tc.refresh_prep(s, cfg, None)
    g = (torch.tensor([1, 0]), s.contact_table)
    a = tct.bucket_contact_table(s, None, cfg, prev=cols, geom=geom, gate=g)
    b = tct.bucket_contact_table(s, None, cfg, geom=geom, gate=g,
                                 prev=(s.contact_key, s.contact_lam))
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))
    assert int(a[0][tct.CT_ACT].sum()) > 50


def test_table_prep_refuses_cpu_tensors():
    s, cfg, _ = _scene("packed")
    st = _displaced(s, cfg, None, ["below"])
    with pytest.raises(ValueError, match="unsupported device"):
        tct.table_prep(st.contact_key, st.contact_lam)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _card_scene(name, dev):
    """(state, cfg, order, gated) at a benchmark scene's shapes."""
    if name == "envs":
        return (scenes.packed_envs(4096, 8, device=dev),
                scenes.packed_env_config(4096, 8), None, True)
    if name in ("pile", "pile4097"):
        n = 4096 if name == "pile" else 4097
        s = scenes.box_pile(n, device=dev)
        cfg = scenes.pile_config(n).replace(contact_rebuild_vel_factor=2.0)
        return s, cfg, sweep_order(s, body_aabbs(s)), True
    return (scenes.mesh_rain(1024, real_assets=False, device=dev),
            scenes.rain_config(1024), None, False)


def _kernel_matches(st, cfg, order, gated):
    n0 = tct.table_prep.launches
    if gated:
        gate, cols, ref = tc.refresh_prep(st, cfg, order)
        assert tct.table_prep.launches == n0 + 1
        gate_p, cols_p, ref_p = tc.refresh_prep(st, cfg, order, plain=True)
        assert gate.dtype == torch.int32
        assert gate.tolist() == gate_p.to(torch.int32).tolist()
        assert torch.equal(_bits(ref), _bits(ref_p))
    else:
        cols, _, _ = tct.table_prep(st.contact_key, st.contact_lam)
        assert tct.table_prep.launches == n0 + 1
        cols_p = tct.prev_key_cols(st.contact_key, st.contact_lam)
        gate = None
    assert torch.equal(_bits(cols), _bits(cols_p))
    return gate


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("name", ["envs", "pile", "pile4097", "rain"])
def test_table_prep_kernel_bitwise(dev, name, nan):
    s, cfg, order, gated = _card_scene(name, dev)
    st = _displaced(s, cfg, order, list(MODES), seed=11, nan=nan)
    gate = _kernel_matches(st, cfg, order, gated)
    if gated and not nan:
        nb = tct.table_shape(st.num_bodies, cfg)[0]
        assert gate.tolist() == [int(g) for g in _expected_gate(nb, MODES)]


def _seq_disp(pos, quat, ref, params):
    """The displacement in f32 with every sum left to right (numpy)."""
    def sum_seq(x):
        acc = x[:, 0]
        for c in range(1, x.shape[1]):
            acc = acc + x[:, c]
        return acc
    dp = np.max(np.abs(pos - ref[:, 0:3]), axis=1)
    dq2 = np.minimum(sum_seq((quat - ref[:, 3:7]) ** 2),
                     sum_seq((quat + ref[:, 3:7]) ** 2))
    r_body = np.sqrt(sum_seq(params ** 2))
    return dp + (np.float32(2.0) * np.sqrt(dq2)) * r_body


@pytest.mark.cuda
def test_table_prep_kernel_sum_order(dev):
    """In every even bucket one body turned at random, its turn term
    2·sqrt(dq2)·|h| 82–95% of the threshold (so that an ulp of dq2 or of
    |h|² moves the displacement by an ulp), and moved along x so that its
    displacement, as refresh_gate computes it on the card, is the
    threshold itself (buckets 0, 4, ...: no fire) or one ulp above it
    (2, 6, ...: fire); every other body below. Summed left to right many
    of those displacements land on the other side: the kernel's gate is
    refresh_gate's only if it adds in PyTorch's order."""
    s, cfg, _, _ = _card_scene("envs", dev)
    st = _displaced(s, cfg, None, ["below"], seed=16)
    n, thr = st.num_bodies, _thr(cfg)
    rng = np.random.default_rng(17)
    pos = st.pos.cpu().numpy().copy()
    ref = st.contact_ref.cpu().numpy().copy()
    quat = st.quat.cpu().numpy().copy()
    radius = st.shapes.params.norm(dim=1).cpu().numpy()
    picked = np.arange(0, n, 2 * BLOCK)
    wants = [thr if k % 2 == 0 else np.nextafter(thr, np.float32(1.0))
             for k in range(len(picked))]
    dxs = {}
    todo = list(range(len(picked)))
    for _ in range(20):                 # rounds of fresh turns
        if not todo:
            break
        i = picked[todo]
        u = rng.normal(0.0, 1.0, (len(i), 4))
        u *= (rng.uniform(0.82, 0.95, len(i)) * thr / (2.0 * radius[i])
              / np.linalg.norm(u, axis=1))[:, None]
        ref[i, 3:7] = quat[i] + u
        ref[i, 0:3] = pos[i]
        st = st.replace(contact_ref=torch.tensor(ref, device=dev))
        # refresh_gate's turn term on the card, 2·sqrt(dq2)·|h| (dp is 0)
        turn = _disp(st).cpu().numpy()
        left = []
        for k in todo:
            t, want = turn[picked[k]], wants[k]
            dx = np.float32(want - t)
            for _ in range(8):
                if np.float32(dx + t) == want:
                    dxs[k] = dx
                    break
                dx = np.nextafter(dx, np.float32(1.0) if dx + t < want
                                  else np.float32(0.0))
            else:               # a round to even steps over want
                left.append(k)
        todo = left
    assert not todo
    for k, i in enumerate(picked):
        ref[i, 0:3] = 0.0
        pos[i] = (dxs[k], 0.0, 0.0)
    st = st.replace(pos=torch.tensor(pos, device=dev),
                    contact_ref=torch.tensor(ref, device=dev))
    disp = _disp(st).cpu().numpy()
    assert np.array_equal(disp[picked[0::2]], np.full(len(picked[0::2]), thr))
    seq = _seq_disp(pos, st.quat.cpu().numpy(), ref,
                    st.shapes.params.cpu().numpy())
    flipped = (seq[picked] > thr) != (disp[picked] > thr)
    assert flipped.sum() >= 5
    gate = _kernel_matches(st, cfg, None, True)
    assert gate.tolist() == [int(b % 4 == 1 or b % 4 == 2)
                             for b in range(len(gate))]


@pytest.mark.cuda
def test_table_prep_kernel_real_displacements(dev):
    """Displacements from steps, not placed: the packed envs 10 steps
    after their last rebuild, the gate mixed by making half the envs
    static."""
    cfg = scenes.packed_env_config(4096, 8)
    s = prepare_contacts(scenes.packed_envs(4096, 8, device=dev), cfg)
    im, ii = s.inv_mass.clone(), s.inv_inertia.clone()
    im[:s.num_bodies // 2], ii[:s.num_bodies // 2] = 0.0, 0.0
    s = s.replace(inv_mass=im, inv_inertia=ii)
    for _ in range(10):
        s, _ = step_with_metrics(s, cfg)
    _kernel_matches(s, cfg, None, True)


@pytest.mark.cuda
@pytest.mark.parametrize("buckets", [(0, 64), (64, 64), (192, 64)])
def test_table_prep_kernel_strided_prev(dev, buckets):
    """The sharded table's bucket range: (keys, λ) sliced along dim 1 and
    read in place."""
    s, cfg, _, _ = _card_scene("envs", dev)
    st = _displaced(s, cfg, None, ["below"], seed=12)
    _, ccap, _ = tct.table_shape(st.num_bodies, cfg)
    b0, nb_l = buckets
    prev = (st.contact_key.narrow(1, b0 * ccap, nb_l * ccap),
            st.contact_lam.narrow(1, b0 * ccap, nb_l * ccap))
    assert not prev[0].is_contiguous()
    cols, _, _ = tct.table_prep(*prev)
    assert torch.equal(_bits(cols), _bits(tct.prev_key_cols(*prev)))


@pytest.mark.cuda
def test_table_prep_kernel_graph_replay(dev):
    """refresh_prep captured into a CUDA graph: one launch at the capture,
    none at a replay; a replay after the inputs change in place gives the
    plain versions' result on the new inputs."""
    s, cfg, order, _ = _card_scene("pile", dev)
    a = _displaced(s, cfg, order, list(MODES), seed=13)
    b = _displaced(s, cfg, order, ["far", "below", "tie"], seed=14)
    tc.refresh_prep(a, cfg, order)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = tct.table_prep.launches
    with torch.cuda.graph(graph):
        out = tc.refresh_prep(a, cfg, order)
    assert tct.table_prep.launches == n0 + 1
    for name in ("pos", "quat", "contact_ref", "contact_key", "contact_lam"):
        getattr(a, name).copy_(getattr(b, name))
    graph.replay()
    torch.cuda.synchronize()
    assert tct.table_prep.launches == n0 + 1
    gate_p, cols_p, ref_p = tc.refresh_prep(b, cfg, order, plain=True)
    assert out[0].tolist() == gate_p.to(torch.int32).tolist()
    assert torch.equal(_bits(out[1]), _bits(cols_p))
    assert torch.equal(_bits(out[2]), _bits(ref_p))
