"""glue_list_us_per_step (layer: hull contact list): device µs a traced
step of the glue (the operations that are not the port's own kernels) in
the generic hull path's contact list: the program's four stages
list_ground, list_prefilter, list_manifolds and list_select, summed. The
stages are read from the program's stage markers, in graphs captured
with tracing on (core/spans.py); None on a program without them."""

from portbench.core import spans

STAGES = ("list_ground", "list_prefilter", "list_manifolds", "list_select")


def read(ctx):
    got = [spans.stage_us(ctx, s) for s in STAGES]
    if any(us is None for us in got):
        return None
    return sum(got)
