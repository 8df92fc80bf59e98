"""list_live_pct (layer: hull contact list): the share of the generic
hull path's slot-major contact list that holds a live contact, 100 ×
list_live ÷ list_slots, from the program's device counters over
core/spans.py's calls (graphs captured again with tracing on): of the
slots that the operands, the sorts and the banded solve carry, those
that carry a contact. None where no such list ran or the program has no
such counters."""

# importing core/spans.py makes the traced run take its pass, which reads
# the counters (ctx.trace.spans)
from portbench.core import spans  # noqa: F401


def read(ctx):
    got = getattr(ctx.trace, "spans", None)
    c = got.counters if got is not None else {}
    if not c.get("list_slots"):
        return None
    return 100.0 * c["list_live"] / c["list_slots"]
