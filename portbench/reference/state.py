"""The reference's state and configuration: plain containers of the
tensors and numbers the box step reads (every body a box)."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

Tensor = torch.Tensor


class Config(SimpleNamespace):
    """The simulation parameters of a configuration file's "sim" object,
    as attributes."""

    def replace(self, **kw) -> "Config":
        return Config(**{**vars(self), **kw})


@dataclasses.dataclass
class Shapes:
    params: Tensor        # [N, 3] box half extents
    friction: Tensor      # [N]
    restitution: Tensor   # [N]


@dataclasses.dataclass
class State:
    pos: Tensor            # [N, 3]
    quat: Tensor           # [N, 4] (w, x, y, z)
    vel: Tensor            # [N, 3]
    omega: Tensor          # [N, 3]
    mass: Tensor           # [N]
    inv_mass: Tensor       # [N]
    inv_inertia: Tensor    # [N, 3, 3] body frame
    shapes: Shapes
    contact_key: Tensor    # [2, C] int32
    contact_lam: Tensor    # [3, C]
    contact_table: Tensor  # [32, C]
    contact_order: Tensor  # [N] int32
    contact_meta: Tensor   # [2] int32
    contact_ref: Tensor    # [N, 7]
    step: int = 0

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def num_bodies(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device
