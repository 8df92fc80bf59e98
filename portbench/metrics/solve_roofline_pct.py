"""solve_roofline_pct (layer: banded solve and integration): the least
time of the fused banded solve and integration (2.3) over the traced
calls, as the yardstick counts it from each step's live contacts, as a
share of the device time of its kernels in the trace."""

from portbench.core import trace, yardstick
from portbench.core.yardstick import GROUPS


def least(st, cfg, s):
    if s.get("table") is None:
        return None
    return yardstick.solve_bound(st, cfg, s)


def read(ctx):
    us = trace.group_us(ctx.trace, GROUPS["2.3 solve"])
    if ctx.least is None or us is None:
        return None
    return 100.0 * 1e3 * ctx.least / us
