"""core/spans.py's reduction on a hand-made trace that carries the
program's stage markers, and the readers of the stage glue and the
gate's fired share on its result."""

from types import SimpleNamespace

import pytest

from portbench.core import spans, spec

STAGES = ("forces", "pairs", "table", "solve", "writeback", "end")


def mark(i, t):
    return (f"void (anonymous namespace)::stage_mark<{i}>()", t, t + 1)


# two steps of a replayed graph, then the call shape's reset (after end)
DEV = [
    ("elementwise_kernel", 0, 4),                    # before any marker
    mark(0, 10), ("vectorized_elementwise_kernel", 12, 15),
    mark(1, 20), ("radixSort", 22, 30), ("sweep_kernel<true>", 31, 40),
    mark(2, 41), ("box_table_pairs", 42, 50), ("reduce_kernel", 51, 53),
    mark(3, 60), ("void (anonymous namespace)::solve_kernel<true>(P)", 61,
                  90), ("copy_", 91, 92),
    mark(4, 93), ("elementwise_kernel", 94, 100),
    mark(5, 101),
    mark(0, 110), ("vectorized_elementwise_kernel", 112, 114),
    mark(4, 120), ("Memcpy DtoD", 121, 125),
    mark(5, 126), ("index_copy", 130, 133),          # the reset
]


def test_glue_by_stage():
    out = spans.reduce(DEV, [], None, 2, STAGES)
    assert out.stage_us == {"forces": 2.5, "pairs": 4.0, "table": 1.0,
                            "solve": 0.5, "writeback": 5.0}
    # before the first marker and after end: 4 + 3 µs over 2 steps
    assert out.stage_ops == {"forces": 1.0, "pairs": 0.5, "table": 0.5,
                             "solve": 0.5, "writeback": 1.0}
    assert out.unattributed_us == 3.5
    assert out.markers_us == 4.5            # 9 markers of 1 µs
    assert out.port_us == {"box_table_pairs": 4.0, "solve_kernel": 14.5,
                           "sweep_kernel": 4.5}
    assert out.idle_gaps == []


def test_no_markers_no_stages():
    out = spans.reduce([("elementwise_kernel", 0, 4)], [], None, 1, STAGES)
    assert out.stage_us == {} and out.unattributed_us == 4.0


def test_idle_gaps_named_by_pt_ranges():
    dev = [mark(0, 10), ("elementwise_kernel", 12, 20),
           ("elementwise_kernel", 40, 50)]
    host = [("pt.replay.False", 15, 45)]
    out = spans.reduce(dev, host, (0, 60), 1, STAGES)
    # gaps 0-10, 11-12 and 50-60 outside the range, 20-40 inside it
    assert dict(out.idle_gaps) == {"pt.replay.False": pytest.approx(
        20e-6), "harness": pytest.approx(21e-6)}


def ctx_of(result):
    return SimpleNamespace(trace=SimpleNamespace(spans=result))


@pytest.mark.parametrize("stage", STAGES[:-1])
def test_stage_readers(stage):
    reader = spec.metric_reader(f"glue_{stage}_us_per_step")
    got = spans.reduce(DEV, [], None, 2, STAGES)
    assert reader.read(ctx_of(got)) == got.stage_us[stage]
    assert reader.read(ctx_of(None)) is None
    assert reader.read(SimpleNamespace(trace=SimpleNamespace())) is None
    empty = spans.reduce([], [], None, 1, STAGES)
    assert reader.read(ctx_of(empty)) is None


def test_gate_fired_pct_reader():
    reader = spec.metric_reader("gate_fired_pct")
    res = SimpleNamespace(counters={"guarded_rebuilds": 0, "gate_fired": 3,
                                    "gate_buckets": 12})
    assert reader.read(ctx_of(res)) == 25.0
    res.counters["gate_buckets"] = 0
    assert reader.read(ctx_of(res)) is None
    assert reader.read(ctx_of(None)) is None
