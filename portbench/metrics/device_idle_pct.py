"""device_idle_pct (layer: device): the card's idle share of unprofiled
calls of the traced run, timed with CUDA events around each call against
the host's clock (trace.idle_between_calls): the time the host holds the
card back between calls. The profiler's own trace is not used for it:
tracing adds 0.4-1.2 us a kernel of device time, which the result line's
busy_s and window_s (the traced calls) carry."""


def read(ctx):
    return ctx.trace.idle_pct
