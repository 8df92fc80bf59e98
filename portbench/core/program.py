"""The system under test: physics_tpu_torch's state built from the
benchmark's arrays, and what every call shape (calls/<name>.py) shares:
the snapshots of the program's state that the reference checks.

With calls/, this is the harness's only code that imports the program."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physics_tpu_torch import engine, scenes
from physics_tpu_torch import state as state_mod
from physics_tpu_torch.config import SimConfig


def program_config(conf: dict) -> SimConfig:
    """The configuration's SimConfig from its factory and overrides, held
    to the file's "sim" values (which the reference reads)."""
    c = conf["config"]
    cfg = getattr(scenes, c["factory"])(*c["args"]).replace(
        **c["overrides"])
    got = {k: (list(v) if isinstance(v, tuple) else v)
           for k, v in dataclasses.asdict(cfg).items()}
    if got != conf["sim"]:
        diff = sorted(k for k in set(got) | set(conf["sim"])
                      if got.get(k) != conf["sim"].get(k))
        raise ValueError(f"configuration {conf['name']}: the factory's "
                         f"SimConfig differs from the file in {diff}")
    return cfg


def build_state(arrays: dict, cfg: SimConfig, device):
    """The program's state of a scene's arrays (core/scene.py), at rest,
    with its contact buffers prepared."""
    n = arrays["pos"].shape[0]
    shapes = dict(arrays["shapes"])
    kind = shapes.pop("kind")
    shapes["stype"] = np.full(
        (n,), getattr(state_mod, f"SHAPE_{kind.upper()}"), np.int32)
    shapes.setdefault("hull_index", np.full((n,), -1, np.int32))
    z = np.zeros((n, 3), np.float32)
    st = state_mod.state_from_arrays(state_mod.make_arrays(
        arrays["pos"], arrays["quat"], z, z, arrays["mass"],
        arrays["inertia"], shapes, arrays.get("hulls"),
        arrays.get("joints")), device)
    return engine.prepare_contacts(st, cfg)


class Program:
    """What a call shape keeps: the traffic's schedule, the program's live
    state (`state`), its output buffer (`out`), and the counts set-up
    reports: `captures` (graph captures so far), `capture_ms` (host ms
    of set-up's warm-up steps and captures, None until every branch is
    captured) and `branches` (those captured). A call shape's `call(k,
    after_step=None)` runs the traffic's call k, calling `after_step(i)`
    after step i, and leaves the output in `out`; nothing waits for the
    device."""

    def __init__(self, cfg: SimConfig, schedule, device, fields):
        self.cfg = cfg
        self.schedule = schedule
        self.device = torch.device(device)
        self.fields = tuple(fields)
        self.captures = 0
        self.capture_ms = None
        self.out = None

    @property
    def state(self):
        raise NotImplementedError

    @property
    def branches(self) -> set:
        return set()

    def host_buffers(self) -> dict:
        """Host buffers (pinned on the card's host) that snapshot_into
        fills."""
        st = self.state
        pin = self.device.type == "cuda"
        return {k: torch.empty(getattr(st, k).shape,
                               dtype=getattr(st, k).dtype, pin_memory=pin)
                for k in self.fields}

    def snapshot_into(self, bufs: dict) -> dict:
        """The state a reference step starts from (the reference's
        SNAPSHOT fields) and the host's step count, copied into host
        buffers: queued on the stream behind the step that made it,
        complete once the call has synchronized."""
        st = self.state
        for k in self.fields:
            bufs[k].copy_(getattr(st, k), non_blocking=True)
        return dict(bufs, step=st.step_count_host)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Free the program's state and buffers."""
        self.out = None


def load_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    from physics_tpu_torch import _build

    _build.library()
