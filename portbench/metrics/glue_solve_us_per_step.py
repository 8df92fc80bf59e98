"""glue_solve_us_per_step (layer: step glue): device µs a traced step of
the glue (the operations that are not the port's own kernels) in the
program's `solve` stage: the table's keys and the solve's operands
(2.3). The stage is read from the program's stage markers, in graphs
captured with tracing on (core/spans.py); None on a program without
them."""

from portbench.core import spans


def read(ctx):
    return spans.stage_us(ctx, "solve")
