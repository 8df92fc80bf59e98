"""glue_us_per_step (layer: step glue): device µs a traced step of the
operations that are not the port's own kernels (PyTorch's element-wise
kernels, reductions, sorts, copies and memsets)."""

from portbench.core.yardstick import PORT


def read(ctx):
    us = [e - s for n, s, e in ctx.trace.device_events
          if not PORT.search(n)]
    if not us or ctx.steps <= 0:
        return None
    return sum(us) / ctx.steps
