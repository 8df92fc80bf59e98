"""Coefficient tables of the linear hull-hull SAT for one hull TYPE PAIR
(physics_tpu/ops/hullhull_batched.py: `HullTables`, `build_hull_tables`).

With hull A of type ia and hull B of type ib, every pairwise SAT quantity
is linear in the 9 components of the relative rotation M = R_aᵀ·R_b:

    face-A support   n_f·(M u)            =  (n_f ⊗ u)        : M
    face-B support   n_f·(Mᵀ v)           =  (v ⊗ n_f)        : M
    edge axis (A)    cross(d₁, M d₂)_i    =  (ε_ijk d₁_j d₂_l) : M
    A-vert on axis   cross(d₁, M d₂)·v    =  ((v×d₁) ⊗ d₂)    : M
    B-vert on axis   cross(Mᵀd₁, d₂)·v    =  (d₁ ⊗ (d₂×v))    : M
    face alignment   n_a·(M n_b)          =  (n_a ⊗ n_b)      : M

so each table row is 9 coefficients that the hull contact table
(ops/hull_table.py) dots with a pair's M. Every product here is an outer
product (the ε contraction has one non-zero term), so the tables are
exact in f32 whatever the evaluation order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class HullTables(NamedTuple):
    """Coefficient tables for one hull type pair (A, B); all shapes are
    the HullSet's shared padded capacities."""

    verts_a: Tensor      # [V, 3] hull-A local vertices
    verts_b: Tensor      # [V, 3] hull-B local vertices
    face_n_a: Tensor     # [F, 3]
    face_n_b: Tensor     # [F, 3]
    face_off_a: Tensor   # [F] (padding planes set to 0)
    face_off_b: Tensor   # [F]
    face_mask_a: Tensor  # [F] f32
    face_mask_b: Tensor  # [F] f32
    face_verts_a: Tensor  # [F, E] int32
    face_verts_b: Tensor  # [F, E] int32
    face_cnt_a: Tensor    # [F] int32
    face_cnt_b: Tensor    # [F] int32
    a_fv: Tensor       # [F·V, 9]  n_f(A) ⊗ u(B)
    b_fv: Tensor       # [F·V, 9]  v(A) ⊗ n_f(B)
    l_ax: Tensor       # [D²·3, 9] ε d(A) d(B)
    c_av: Tensor       # [D²·V, 9] (v(A)×d(A)) ⊗ d(B)
    c_bv: Tensor       # [D²·V, 9] d(A) ⊗ (d(B)×v(B))
    ff: Tensor         # [F·F, 9]  n(A) ⊗ n(B)
    ax_mask: Tensor    # [D²] f32  dmask(A) ⊗ dmask(B)
    edge_i0_a: Tensor  # [E2] int32 unique-edge endpoints (A's edge list)
    edge_i1_a: Tensor
    edge_mask_a: Tensor  # [E2] f32
    edge_i0_b: Tensor
    edge_i1_b: Tensor
    edge_mask_b: Tensor


def _levi_civita(device) -> Tensor:
    eps = torch.zeros((3, 3, 3), dtype=torch.float32, device=device)
    for (i, j, k, s) in [(0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
                         (0, 2, 1, -1.0), (1, 0, 2, -1.0), (2, 1, 0, -1.0)]:
        eps[i, j, k] = s
    return eps


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis, componentwise as jnp.cross."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def build_hull_tables(hulls, idx: int = 0, idx_b: int | None = None
                      ) -> HullTables:
    """Coefficient tables for hull type pair (idx, idx_b) of a HullSet;
    idx_b=None ⇒ the shared-hull case (B = A)."""
    if idx_b is None:
        idx_b = idx
    dev = hulls.verts.device

    def side(i):
        v = hulls.verts[i]                                 # [V, 3]
        nf = hulls.face_normals[i]                         # [F, 3]
        off = hulls.face_offsets[i]                        # [F]
        fmask = torch.isfinite(off).to(torch.float32)
        # the 1e30 padding planes are finite in f32; as in the JAX
        # package they stay in the offsets and only ±inf is masked
        off = torch.where(fmask > 0, off, torch.zeros_like(off))
        d = hulls.edge_dirs[i]                             # [D, 3]
        dmask = (torch.arange(d.shape[0], device=dev)
                 < hulls.edge_dir_count[i]).to(torch.float32)
        emask = (torch.arange(hulls.edge_i0.shape[1], device=dev)
                 < hulls.edge_count[i]).to(torch.float32)
        return v, nf, off, fmask, d, dmask, emask

    va, nfa, offa, fmaska, da, dmaska, emaska = side(idx)
    vb, nfb, offb, fmaskb, db, dmaskb, emaskb = side(idx_b)

    f, vc, dc = nfa.shape[0], va.shape[0], da.shape[0]
    eps = _levi_civita(dev)
    a_fv = torch.einsum("fk,ul->fukl", nfa, vb).reshape(f * vc, 9)
    b_fv = torch.einsum("uk,fl->fukl", va, nfb).reshape(f * vc, 9)
    l_ax = torch.einsum("ijk,aj,bl->abikl", eps, da, db).reshape(
        dc * dc * 3, 9)
    vxd = _cross(va[None, :, :], da[:, None, :])      # [D, V, 3] v_u × d_a
    c_av = torch.einsum("auk,bl->abukl", vxd, db).reshape(dc * dc * vc, 9)
    dxv = _cross(db[:, None, :], vb[None, :, :])      # [D, V, 3] d_b × v_u
    c_bv = torch.einsum("ak,bul->abukl", da, dxv).reshape(dc * dc * vc, 9)
    ff = torch.einsum("ak,bl->abkl", nfa, nfb).reshape(f * f, 9)
    ax_mask = (dmaska[:, None] * dmaskb[None, :]).reshape(-1)

    return HullTables(
        verts_a=va, verts_b=vb,
        face_n_a=nfa, face_n_b=nfb,
        face_off_a=offa, face_off_b=offb,
        face_mask_a=fmaska, face_mask_b=fmaskb,
        face_verts_a=hulls.face_verts[idx],
        face_verts_b=hulls.face_verts[idx_b],
        face_cnt_a=hulls.face_vert_count[idx],
        face_cnt_b=hulls.face_vert_count[idx_b],
        a_fv=a_fv, b_fv=b_fv, l_ax=l_ax, c_av=c_av, c_bv=c_bv, ff=ff,
        ax_mask=ax_mask,
        edge_i0_a=hulls.edge_i0[idx], edge_i1_a=hulls.edge_i1[idx],
        edge_mask_a=emaska,
        edge_i0_b=hulls.edge_i0[idx_b], edge_i1_b=hulls.edge_i1[idx_b],
        edge_mask_b=emaskb,
    )
