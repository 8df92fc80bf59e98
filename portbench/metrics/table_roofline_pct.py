"""table_roofline_pct (layer: box contact table): the least time of the
box contact table (2.2) over the traced calls, as the yardstick counts
it from each step's inputs (only the fired buckets on a gated refresh),
as a share of the device time of its kernels in the trace."""

from portbench.core import trace, yardstick
from portbench.core.yardstick import GROUPS


def least(st, cfg, s):
    if s.get("table_call") is None:
        return None
    if s.get("cand") is not None:
        return yardstick.candidates_table_bound(st, cfg, s)
    return yardstick.mode_bound(st, cfg, s)


def read(ctx):
    us = trace.group_us(ctx.trace, GROUPS["2.2 contact table"])
    if ctx.least is None or us is None:
        return None
    return 100.0 * 1e3 * ctx.least / us
