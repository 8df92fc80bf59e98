"""gate_fired_pct (layer: box contact table): the share of the buckets
that the gated refresh evaluated which its gate fired (recomputed from
the current poses), 100 × gate_fired ÷ gate_buckets, from the program's
device counters over core/spans.py's calls; None where no gate ran or
the program has no such counters."""

from portbench.core import spans


def read(ctx):
    return spans.gate_fired_pct(ctx)
