"""Packed environments (physics_tpu/envs.py `pack_envs`, `unpack_envs`).

A batch of E environments of K bodies each steps as ONE scene of E·K
bodies, body id e·K + k. With broadphase="env_blocks" the contact table
forms only the pairs inside one env (the identity order puts env e's
bodies on ranks e·K … e·K + K − 1), so the envs never interact, and the
whole batch shares one table launch and one solve a step.

The batched layout is the one `jax.vmap` gives the JAX package: a
SimState whose every tensor has a leading [E] axis — per-body fields
[E, K, ...], the hull library [E, H, ...], joints [E, J, ...], the
contact buffers [E, ...], step_count [E] — and whose step_count_host is
env 0's. `offset_envs` builds one from a single scene; `stack_states`,
the per-env health checks and the auto-resets are ROADMAP item 1.14.
"""

from __future__ import annotations

import dataclasses

import torch

from physics_tpu_torch.state import SimState

Tensor = torch.Tensor


def _map(state, fn):
    """`state` with fn applied to every tensor, nested structs included."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _map(v, fn)
        elif isinstance(v, Tensor):
            kw[f.name] = fn(v)
    return state.replace(**kw)


def offset_envs(base: SimState, offsets: Tensor) -> SimState:
    """E copies of one scene in the batched layout, env e's bodies moved
    by offsets[e] ([E, 1, 3] or [E, 3]): what `jax.vmap(lambda o:
    base.replace(pos=base.pos + o))(offsets)` gives the JAX package. The
    env-invariant fields are broadcast views of `base`'s."""
    e = offsets.shape[0]
    batched = _map(base, lambda a: a.expand((e,) + a.shape))
    return batched.replace(pos=base.pos + offsets.reshape(e, 1, 3))


def pack_envs(batched: SimState) -> SimState:
    """Flatten a batched [E, K, ...] state into one [E·K]-body scene:
    body id e·K + k. Env-invariant fields (the hull library, the step
    counter) are taken from env 0; joints concatenate with their body ids
    offset by e·K (−1, the world, stays); the contact warm-start buffers
    are reset — call engine.prepare_contacts on the packed state."""
    e, k = batched.pos.shape[:2]

    def flat(a):
        return a.reshape((e * k,) + a.shape[2:])

    def flat_j(a):
        return a.reshape((-1,) + a.shape[2:])

    def take0(tree):
        return _map(tree, lambda a: a[0])

    js = batched.joints
    if js.capacity > 0:
        off = (torch.arange(e, dtype=torch.int32, device=js.body_a.device)
               * k)[:, None]
        joints = js.replace(
            jtype=flat_j(js.jtype),
            body_a=flat_j(js.body_a + off),
            body_b=flat_j(torch.where(js.body_b >= 0, js.body_b + off, -1)),
            params=flat_j(js.params), ks=flat_j(js.ks), kd=flat_j(js.kd))
        lam_joint = batched.lam_joint.reshape(-1)
    else:
        joints = take0(js)
        lam_joint = batched.lam_joint[0]
    dev = batched.pos.device
    i32, f32 = torch.int32, torch.float32
    return batched.replace(
        pos=flat(batched.pos), quat=flat(batched.quat),
        vel=flat(batched.vel), omega=flat(batched.omega),
        force=flat(batched.force), torque=flat(batched.torque),
        mass=flat(batched.mass), inv_mass=flat(batched.inv_mass),
        inertia=flat(batched.inertia), inv_inertia=flat(batched.inv_inertia),
        joints=joints, lam_joint=lam_joint,
        shapes=_map(batched.shapes, flat),
        hulls=take0(batched.hulls),
        contact_key=torch.zeros((0,), dtype=i32, device=dev),
        contact_lam=torch.zeros((3, 0), dtype=f32, device=dev),
        contact_table=torch.zeros((0, 0), dtype=f32, device=dev),
        contact_order=torch.zeros((0,), dtype=i32, device=dev),
        contact_meta=torch.zeros((2,), dtype=i32, device=dev),
        contact_ref=torch.zeros((0, 0), dtype=f32, device=dev),
        step_count=batched.step_count[0],
    )


def unpack_envs(state: SimState, n_envs: int) -> SimState:
    """The inverse of `pack_envs` for the per-body fields ([E·K] →
    [E, K]); joints, the hull library and the step counter are broadcast
    to every env as they are, and the contact buffers are empty."""
    e = n_envs
    k = state.num_bodies // e
    dev = state.device
    i32, f32 = torch.int32, torch.float32

    def unflat(a):
        return a.reshape((e, k) + a.shape[1:])

    def tile(a):
        return a.expand((e,) + a.shape)

    return state.replace(
        pos=unflat(state.pos), quat=unflat(state.quat),
        vel=unflat(state.vel), omega=unflat(state.omega),
        force=unflat(state.force), torque=unflat(state.torque),
        mass=unflat(state.mass), inv_mass=unflat(state.inv_mass),
        inertia=unflat(state.inertia), inv_inertia=unflat(state.inv_inertia),
        joints=_map(state.joints, tile), lam_joint=tile(state.lam_joint),
        shapes=_map(state.shapes, unflat),
        hulls=_map(state.hulls, tile),
        contact_key=torch.zeros((e, 0), dtype=i32, device=dev),
        contact_lam=torch.zeros((e, 3, 0), dtype=f32, device=dev),
        contact_table=torch.zeros((e, 0, 0), dtype=f32, device=dev),
        contact_order=torch.zeros((e, 0), dtype=i32, device=dev),
        contact_meta=torch.zeros((e, 2), dtype=i32, device=dev),
        contact_ref=torch.zeros((e, 0, 0), dtype=f32, device=dev),
        step_count=tile(state.step_count),
    )
