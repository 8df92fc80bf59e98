"""The packed jointed envs of the port's joint slice, built as
tests/test_pack_envs.py builds them (SceneBuilder and pack_envs; no
scene function of the package): E two-body pendulums, body 0 at (1, 0, 0)
pinned to the origin (fix_to_point), body 1 at (1, 2, 0) on a ball joint
to it (anchors (0, 1, 0) and (0, −1, 0)), each env moved by
uniform(−0.1, 0.1) from numpy's default_rng(seed), its pin with it.

This module imports no JAX, so the GPU tests (tests/test_torch_cuda.py,
run without tests/conftest.py) build the scene from it too; the JAX
package's side is in tests/test_torch_joints.py.
"""

import numpy as np
import torch

from physics_tpu_torch.envs import offset_envs, pack_envs
from physics_tpu_torch.io.meshes import box_inertia
from physics_tpu_torch.scene import SceneBuilder
from physics_tpu_torch.state import JOINT_BALL, JOINT_FIX_POINT


def pendulum(builder_cls, inertia_fn, **build):
    """One pendulum env with `builder_cls` (either package's
    SceneBuilder) and its box_inertia."""
    b = builder_cls()
    i0 = b.add_body(pos=(1.0, 0.0, 0.0), inertia=inertia_fn((0.5,) * 3, 1.0))
    b.fix_to_point(i0, (0.0, 0.0, 0.0))
    i1 = b.add_body(pos=(1.0, 2.0, 0.0), inertia=inertia_fn((0.3,) * 3, 1.0))
    b.ball_joint(i0, i1, anchor_a=(0, 1, 0), anchor_b=(0, -1, 0))
    return b.build(**build)


def env_offsets(n_envs: int, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -0.1, 0.1, (n_envs, 1, 3)).astype(np.float32)


def packed_pendulums(n_envs: int, seed: int = 2, device="cpu"):
    """(the packed scene of n_envs pendulums, their offsets [E, 1, 3])."""
    offs = env_offsets(n_envs, seed)
    base = pendulum(SceneBuilder, box_inertia, device=device)
    off = torch.from_numpy(offs).to(base.device)
    batched = offset_envs(base, off)
    params = batched.joints.params.clone()
    params[:, 0, 0:3] += off[:, 0, :]
    return pack_envs(batched.replace(
        joints=batched.joints.replace(params=params))), offs


def test_packed_pendulums_layout():
    """4,096 envs: 8,192 bodies and joint slots (24,576 CG rows), env e's
    joints on bodies 2e and 2e + 1, each pin at its env's offset."""
    s, offs = packed_pendulums(4096)
    assert s.num_bodies == 8192 and s.joints.capacity == 8192
    assert s.lam_joint.shape == (24576,)
    e = torch.arange(4096, dtype=torch.int32)
    assert torch.equal(s.joints.jtype[0::2], torch.full_like(
        e, JOINT_FIX_POINT))
    assert torch.equal(s.joints.jtype[1::2], torch.full_like(e, JOINT_BALL))
    assert torch.equal(s.joints.body_a[0::2], 2 * e)
    assert torch.equal(s.joints.body_a[1::2], 2 * e)
    assert torch.equal(s.joints.body_b[0::2], torch.full_like(e, -1))
    assert torch.equal(s.joints.body_b[1::2], 2 * e + 1)
    assert np.array_equal(s.joints.params[0::2, 0:3].numpy(), offs[:, 0])
    assert np.array_equal(s.pos[0::2].numpy(),
                          np.float32([1, 0, 0]) + offs[:, 0])
