"""One engine.DeviceStepper held across calls, as an RL loop or a
recorder holds it: a call runs the mix's steps through the stepper's
captured graphs, then resets the bodies of the envs whose episode ends
with it (in place in the stepper's static state, at rest, as legged_gym's
reset_idx does after the physics steps), then gathers the output on the
device ("poses": pos | quat of every body; "obs": pos | quat | vel |
omega). The first steps of set-up warm up and capture each branch of
the step."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from physics_tpu_torch import engine
from portbench.core.program import Program, build_state


def _eager_capture(fn, pool):
    """A stand-in for engine.capture_graph off the card: the step runs
    eagerly at each replay."""
    return SimpleNamespace(replay=fn, pool=lambda: None)


class Call(Program):
    def __init__(self, cfg, arrays: dict, schedule, device, fields):
        super().__init__(cfg, schedule, device, fields)
        self._branches = 2 if cfg.contact_rebuild > 1 else 1
        capture = (engine.capture_graph if self.device.type == "cuda"
                   else _eager_capture)

        def counted(fn, pool):
            self.captures += 1
            return capture(fn, pool)

        self.stepper = engine.DeviceStepper(
            build_state(arrays, cfg, self.device), cfg, capture=counted)
        n = arrays["pos"].shape[0]
        width = {"poses": 7, "obs": 13}[schedule.output]
        self.out = torch.zeros((n, width), dtype=torch.float32,
                               device=self.device)
        self.pool = None
        if schedule.resets:
            pos, quat = schedule.pool
            self.pool = (torch.as_tensor(pos, device=self.device),
                         torch.as_tensor(quat, device=self.device))
            self.reset_idx = [torch.as_tensor(b, device=self.device)
                              for b in schedule.phase_bodies]

    @property
    def state(self):
        return self.stepper.state

    @property
    def branches(self) -> set:
        return self.stepper.captured

    def call(self, k: int, after_step=None) -> None:
        st = self.stepper.state
        for i in range(self.schedule.steps_per_call):
            if self.capture_ms is None:
                st = self._warm_up_step()
            else:
                st = self.stepper.step()
            if after_step is not None:
                after_step(i)
        if self.pool is not None:
            phase, slot = self.schedule.reset_of(k)
            idx = self.reset_idx[phase]
            if idx.numel():
                st.pos.index_copy_(0, idx, self.pool[0][slot].index_select(
                    0, idx))
                st.quat.index_copy_(0, idx, self.pool[1][slot].index_select(
                    0, idx))
                st.vel.index_fill_(0, idx, 0.0)
                st.omega.index_fill_(0, idx, 0.0)
        parts = [st.pos, st.quat]
        if self.schedule.output == "obs":
            parts += [st.vel, st.omega]
        torch.cat(parts, dim=1, out=self.out)

    def _warm_up_step(self):
        """A step while some branch is not captured yet, timed from the
        first: capture_ms ends on the synchronize after the last capture."""
        if not hasattr(self, "_t0"):
            self.sync()
            self._t0 = time.perf_counter()
        st = self.stepper.step()
        if len(self.stepper.captured) == self._branches:
            self.sync()
            self.capture_ms = 1e3 * (time.perf_counter() - self._t0)
        return st

    def close(self) -> None:
        self.stepper = None
        self.pool = None
        super().close()
