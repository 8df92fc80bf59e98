"""E envs of K boxes packed into one scene, body e·K + k: each env draws
its own boxes from scenes.random_env's distribution from (seed, stream),
stream 0 for the scene and 1.. for the resets, and keeps the port's
scenes.packed_envs offsets (default_rng(offset_seed))."""

from __future__ import annotations

import numpy as np

from portbench.core.scene import boxes, quat_from_euler


def env_offsets(p: dict) -> np.ndarray:
    """[E, 1, 3] f32: env e's offset (the port's scenes.packed_envs)."""
    rng = np.random.default_rng(p["offset_seed"])
    return rng.uniform(-p["offset"], p["offset"],
                       (p["n_envs"], 1, 3)).astype(np.float32)


def env_draws(p: dict, seed: int, stream: int):
    """(pos [E, K, 3], quat [E, K, 4]) f32: every env's own K boxes, drawn
    as scenes.random_env draws them (per body: pos, then euler), offset
    by the env's offset."""
    e, k = p["n_envs"], p["n_bodies"]
    rng = np.random.default_rng([seed, stream])
    u = rng.random((e, k, 6))
    lo, hi = np.asarray(p["pos_low"]), np.asarray(p["pos_high"])
    pos = (lo + (hi - lo) * u[..., :3]).astype(np.float32)
    euler = (-p["euler"] + 2.0 * p["euler"] * u[..., 3:]).astype(np.float32)
    return pos + env_offsets(p), quat_from_euler(euler)


def make(p: dict, seed: int) -> dict:
    pos, quat = env_draws(p, seed, 0)
    n = p["n_envs"] * p["n_bodies"]
    return boxes(pos.reshape(n, 3), quat.reshape(n, 4), p)


def reset_pool(p: dict, seed: int, slots: int):
    """(pos [M, N, 3], quat [M, N, 4]): the poses every body takes at its
    resets, slot j's from stream 1 + j."""
    n = p["n_envs"] * p["n_bodies"]
    draws = [env_draws(p, seed, 1 + j) for j in range(slots)]
    return (np.stack([d[0].reshape(n, 3) for d in draws]),
            np.stack([d[1].reshape(n, 4) for d in draws]))
