"""capture_ms (layer: horizon): host ms of set-up's first call, which
runs the eager warm-up step of each branch of the step and captures its
CUDA graph, ending in a synchronize."""


def read(ctx):
    return ctx.capture_ms
