"""How the ranks of a row-sharded step talk (physics_tpu/solver/contacts.py
`_chunk`, `_chunk_contacts`; the psum and all_gather of
physics_tpu/solver/contacts_pallas.py `banded_sweeps_sharded`).

The solver and the engine take a Shard; the collectives take its process
group. With NCCL each rank has a card of its own. gloo runs any number of
ranks, also several on one card; it stages CUDA tensors through the host
anyway, and these helpers do it explicitly (`_staged`) so that every
collective gloo runs is on CPU tensors. This module imports nothing of
the package: parallel/sharding.py, which spawns the ranks and builds the
step, sits above the solver.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class Shard(NamedTuple):
    """The calling rank's place in a process group."""

    group: object | None   # the process group (None: the default group)
    rank: int
    size: int

    def check_device(self, device: torch.device) -> None:
        """NCCL moves CUDA tensors only: refuse a state elsewhere rather
        than move it."""
        if device.type != "cuda" and dist.get_backend(self.group) == "nccl":
            raise ValueError("row sharding over NCCL needs the state on "
                             "this rank's card")


def shard_of(group=None) -> Shard:
    """The calling rank's Shard in `group` (an initialised process
    group; None is the default group)."""
    if not dist.is_initialized():
        raise RuntimeError("row sharding: call "
                           "torch.distributed.init_process_group first")
    return Shard(group, dist.get_rank(group), dist.get_world_size(group))


def _staged(t: Tensor, shard: Shard) -> bool:
    return t.is_cuda and dist.get_backend(shard.group) == "gloo"


def all_reduce_sum(t: Tensor, shard: Shard) -> Tensor:
    """Σ over the ranks of t, in place; returns t."""
    if _staged(t, shard):
        h = t.cpu()
        dist.all_reduce(h, group=shard.group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=shard.group)
    return t


def all_gather_last(t: Tensor, shard: Shard) -> Tensor:
    """The ranks' t (same shape on every rank) concatenated along the last
    axis, in rank order."""
    if t.dtype == torch.bool:
        return all_gather_last(t.to(torch.uint8), shard).to(torch.bool)
    src = t.cpu() if _staged(t, shard) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(shard.size)]
    dist.all_gather(parts, src, group=shard.group)
    return torch.cat(parts, dim=-1).to(t.device)


def chunk(x: Tensor, shard: Shard, dim: int = 0) -> Tensor:
    """This rank's contiguous slice of x along `dim`, x zero-padded (zero
    and False are inactive) up to a multiple of the rank count."""
    rem = x.shape[dim] % shard.size
    if rem:
        after = x.dim() - 1 - dim % x.dim()    # dims after `dim`: no pad
        pad = [0, 0] * after + [0, shard.size - rem]
        x = torch.nn.functional.pad(x, pad)
    size = x.shape[dim] // shard.size
    return x.narrow(dim, shard.rank * size, size).contiguous()


def chunk_contacts(contacts, shard: Shard):
    """Every field of a Contacts buffer chunked along its contact axis."""
    return type(contacts)(*[
        chunk(getattr(contacts, f), shard,
              dim=1 if f in ("point", "normal") else 0)
        for f in contacts._fields])
