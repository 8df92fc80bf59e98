"""glue_writeback_us_per_step (layer: step glue): device µs a traced step
of the glue (the operations that are not the port's own kernels) in the
program's `writeback` stage: the solve's outputs in body order, the
step's last fields and the stepper's copy into its static buffers. The
stage is read from the program's stage markers, in graphs captured with
tracing on (core/spans.py); None on a program without them."""

from portbench.core import spans


def read(ctx):
    return spans.stage_us(ctx, "writeback")
