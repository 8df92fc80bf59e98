"""hull_sat_pass_pct (layer: hull contact table): the share of the SAT
lanes that the hull contact table (2.4) evaluated whose SAT found the
two hulls overlapping, 100 × hull_sat_pass ÷ hull_sat_lanes, from the
program's device counters over core/spans.py's calls (graphs captured
again with tracing on); None where no hull table ran or the program has
no such counters."""

# importing core/spans.py makes the traced run take its pass, which reads
# the counters (ctx.trace.spans)
from portbench.core import spans  # noqa: F401


def read(ctx):
    got = getattr(ctx.trace, "spans", None)
    c = got.counters if got is not None else {}
    if not c.get("hull_sat_lanes"):
        return None
    return 100.0 * c["hull_sat_pass"] / c["hull_sat_lanes"]
