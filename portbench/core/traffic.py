"""The one generator of every traffic mix: a mix is a data file of
parameters (traffic/<name>.json), and this turns it into the schedule of
calls a run drives.

A call of the call shape `call` (calls/<call>.py) runs `steps_per_call`
steps and gathers the output ("poses": pos | quat of every body; "obs":
pos | quat | vel | omega). Set-up runs `settle_steps` steps as whole
calls before the window. With `episode_calls` > 0 the scene is packed
envs and each env's episode ends once every `episode_calls` calls, at
its phase: a permutation of the envs drawn from `phase_seed`, never from
--seed, so every seed resets the same envs at the same calls; call k
resets, after its steps, the envs whose phase is k mod episode_calls.
Env e's j-th reset takes its poses from the reset pool's slot j mod
`reset_pool`, drawn by the scene builder's reset_pool from --seed.
The reference checks, step by step, the first `check_steps` steps of
the compared calls and the last step of each (check.py), and the traced
run profiles `trace_calls` calls."""

from __future__ import annotations

import numpy as np

KEYS = {"call", "steps_per_call", "settle_steps", "episode_calls", "output",
        "check_steps", "trace_calls"}
RESET_KEYS = {"phase_seed", "reset_pool"}


class Schedule:
    def __init__(self, params: dict, scene_params: dict, seed: int,
                 builder=None):
        """`builder`: the scene builder's module (scenes/<builder>.py),
        whose reset_pool a mix with resets draws from."""
        missing = KEYS - set(params)
        if missing:
            raise ValueError(f"traffic: missing {sorted(missing)}")
        self.call = params["call"]
        self.steps_per_call = int(params["steps_per_call"])
        if params["settle_steps"] % self.steps_per_call:
            raise ValueError("traffic: settle_steps must be whole calls")
        self.settle_calls = params["settle_steps"] // self.steps_per_call
        self.episode_calls = int(params["episode_calls"])
        self.output = params["output"]
        self.check_steps = int(params["check_steps"])
        self.trace_calls = int(params["trace_calls"])
        self.resets = self.episode_calls > 0
        self.phase_bodies = []
        self.pool = None
        if self.resets:
            if RESET_KEYS - set(params):
                raise ValueError(f"traffic: resets need {sorted(RESET_KEYS)}")
            e, k = scene_params["n_envs"], scene_params["n_bodies"]
            perm = np.random.default_rng(params["phase_seed"]).permutation(e)
            phase = perm % self.episode_calls
            bodies = np.arange(e * k).reshape(e, k)
            self.phase_bodies = [bodies[phase == p].reshape(-1)
                                 for p in range(self.episode_calls)]
            self.pool_slots = int(params["reset_pool"])
            if not hasattr(builder, "reset_pool"):
                raise ValueError(f"traffic: the scene builder "
                                 f"{scene_params['builder']!r} has no "
                                 f"reset_pool")
            self.pool = builder.reset_pool(scene_params, seed,
                                           self.pool_slots)

    def reset_of(self, k: int):
        """(phase, pool slot) of the resets at the end of call k."""
        return k % self.episode_calls, (k // self.episode_calls) % (
            self.pool_slots)

    def resets_of(self, k: int):
        """(bodies [R] int64, pos [R, 3], quat [R, 4]) that call k resets
        after its steps (None without resets)."""
        if not self.resets:
            return None
        phase, slot = self.reset_of(k)
        idx = self.phase_bodies[phase]
        return idx, self.pool[0][slot][idx], self.pool[1][slot][idx]

    def bodies_reset(self, k: int) -> int:
        """How many bodies call k resets."""
        if not self.resets:
            return 0
        return len(self.phase_bodies[self.reset_of(k)[0]])
