"""banded_roofline_pct (layer: banded solve): the least time of the
unfused banded solve (2.5, with 2.6's constants in its sweep 0) over the
traced calls, counted from each step's operands by the bound below, as a
share of the device time of its kernel in the trace
(solve_kernel<false>).

The bound is a frozen copy of chip_smoke.py's in check_generic_solve,
taking the reference's tensors of a step (reference/hull_list_step.py's
on_step) in place of the program's: z0's (v, ω) of the n bodies, the
bases and the two lane operands, every slot's activity, the other
constant rows of each touched slot and the 24 solve rows of the columns
the touched slots reach read; z's velocities, pseudo-velocities and
degrees and λ written; 2.6's constants and sweep 0 for each touched
slot, each later sweep for the live ones. The peaks and the operations a
contact costs are core/yardstick.py's."""

import re

import torch

from portbench.core import trace
from portbench.core.yardstick import (
    OPS_SOLVE_CONTACT,
    OPS_SOLVE_PREP,
    bound,
    live_count,
    nbytes,
)

KERNEL = re.compile(r"(?<![A-Za-z_])solve_kernel<false>")
CIN_ROWS = 14


def touched_columns(bases, tile, *locs) -> int:
    """How many columns of the rank-space table the live lanes of the
    window-local ranks `locs` (−1: none) reach."""
    base = bases.long().repeat_interleave(tile)
    return int(torch.cat([(base + loc.long())[loc >= 0]
                          for loc in locs]).unique().numel())


def least(st, cfg, s):
    """2.5's least time on a step's operands (None where the step has no
    banded solve)."""
    ops = s.get("banded")
    if ops is None:
        return None
    n = st.num_bodies
    cp = ops.la.shape[0]
    n_touch = int((ops.la >= 0).sum())
    live = live_count(ops.consts, ops.use_split)
    cols = touched_columns(ops.bases, ops.tile, ops.la, ops.lb)
    moved = (4 * 6 * n + nbytes(ops.bases, ops.la, ops.lb)
             + 4 * (6 + 7) * n + 4 * 4 * cp + 4 * cp
             + 4 * (CIN_ROWS - 1) * n_touch + 4 * 24 * cols)
    return bound(moved, OPS_SOLVE_PREP * n_touch + OPS_SOLVE_CONTACT * (
        n_touch + (s["sweeps"] - 1) * live))


def read(ctx):
    us = trace.group_us(ctx.trace, KERNEL)
    if ctx.least is None or us is None:
        return None
    return 100.0 * 1e3 * ctx.least / us
