"""sweep_roofline_pct (layer: broad phase): the least time of the
bucketed sweep candidates (2.1) over the traced calls, as the yardstick
counts it from each rebuild's inputs, as a share of the device time of
its kernels in the trace."""

from portbench.core import trace, yardstick
from portbench.core.yardstick import GROUPS


def least(st, cfg, s):
    if s.get("cand") is None:
        return None
    return yardstick.sweep_bound(st, cfg, s)


def read(ctx):
    us = trace.group_us(ctx.trace, GROUPS["2.1 sweep"])
    if ctx.least is None or us is None:
        return None
    return 100.0 * 1e3 * ctx.least / us
