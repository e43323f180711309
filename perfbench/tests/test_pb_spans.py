"""perfbench/harness/spans.py: the idle gaps between busy intervals put
down, nanosecond by nanosecond, to the program's stage-level spans or to
"outside", and the readers built on it, on synthetic device events and
spans; None where the log dropped spans or holds none."""

import pytest

from perfbench.harness import discovery, spans
from sdn3d_tpu_torch.utils.phases import Span

# busy [0, 10), [12, 20), [30, 40), [41, 50), [60, 70), [75, 80): gaps
# [10, 12), [20, 30), [40, 41), [50, 60), [70, 75) = 28 ns
DEVICE = [("k", 0, 6), ("k", 4, 10), ("k", 12, 20), ("k", 30, 40),
          ("k", 41, 50), ("k", 60, 70), ("copy", 75, 80)]
SPANS = [
    Span("chain.request", 5, 90, 1, 0, 1),
    Span("stage.semantic", 8, 25, 2, 1, 1),      # gaps: 2 + 5
    Span("sem.infer", 9, 11, 3, 2, 1),           # a sub-span: its stage's
    Span("stage.geometric", 27, 55, 4, 1, 1),    # 3 + 1 + 5
    Span("stage.textural", 58, 72, 5, 1, 1),     # 2 + 2
    Span("train.forward", 73, 74, 6, 0, 2),      # 1
]
COUNTS = {"count.cache.label.hit": 3, "count.cache.label.miss": 1,
          "count.cache.encode.hit": 3, "count.cache.encode.miss": 1,
          "count.cache.source.miss": 4, "count.semantic_pass": 1}


def log(spans_=SPANS, dropped=0):
    return {"spans": list(spans_), "counts": dict(COUNTS),
            "dropped": dropped}


def test_every_idle_nanosecond_is_put_down_once():
    t = {"device_events": DEVICE}
    r = spans.idle(t, log())
    assert r["gap_ns"] == 28
    assert r["idle_ns"] == {"stage.semantic": 7, "stage.geometric": 9,
                            "stage.textural": 4, "train.forward": 1}
    assert r["outside_ns"] == 7                  # [25, 27) + [55, 58) + 2
    assert sum(r["idle_ns"].values()) + r["outside_ns"] == r["gap_ns"]
    assert r["counts"] == COUNTS
    assert spans.idle(t, log(dropped=1)) is r    # computed once a run


def test_nested_stage_spans_give_the_innermost():
    pieces = spans.segments([(0, 10, "stage.a"), (2, 5, "stage.b"),
                             (12, 14, "stage.c")])
    assert pieces == [(0, 2, "stage.a"), (2, 5, "stage.b"),
                      (5, 10, "stage.a"), (12, 14, "stage.c")]
    r = spans.attribute([(0, 1), (13, 20)], pieces)
    assert r["idle_ns"] == {"stage.a": 6, "stage.b": 3, "stage.c": 1}
    assert r["outside_ns"] == 2 and r["gap_ns"] == 12


@pytest.mark.parametrize("bad", [log(dropped=1), log(spans_=[])],
                         ids=["dropped", "no spans"])
def test_none_without_a_whole_log(bad):
    t = {"device_events": DEVICE, "units_prof": 2}
    assert spans.idle(t, bad) is None
    assert spans.idle_ms_per_unit(t, "stage.semantic") is None
    assert spans.outside_share(t) is None


def test_none_from_a_port_without_the_log(monkeypatch):
    """A port older than the profiled log (no phases.profiled) reads None,
    so every reader reports nothing instead of raising."""
    from sdn3d_tpu_torch.utils import phases
    monkeypatch.delattr(phases, "profiled")
    t = {"device_events": DEVICE, "units_prof": 2}
    assert spans.program_log() is None and spans.idle(t) is None
    assert discovery.metric_reader("semantic_passes.edit").read(t) is None


def test_the_readers():
    t = {"device_events": DEVICE, "units_prof": 2}
    spans.idle(t, log())
    read = {n: discovery.metric_reader(n).read(t) for n in (
        "semantic_idle_ms.edit", "geometric_idle_ms.edit",
        "textural_idle_ms.edit", "outside_idle_share.edit",
        "cache_hit_share.edit", "semantic_passes.edit",
        "forward_idle_ms.train", "backward_idle_ms.train",
        "optimizer_idle_ms.train", "outside_idle_share.train")}
    assert read == pytest.approx({
        "semantic_idle_ms.edit": 3.5e-6, "geometric_idle_ms.edit": 4.5e-6,
        "textural_idle_ms.edit": 2e-6, "outside_idle_share.edit": 25.0,
        "cache_hit_share.edit": 50.0, "semantic_passes.edit": 0.5,
        "forward_idle_ms.train": 0.5e-6, "backward_idle_ms.train": 0.0,
        "optimizer_idle_ms.train": 0.0, "outside_idle_share.train": 25.0})
    # idle ms a unit times the units, plus the outside share, is the gap
    r = t["span_idle"]
    assert sum(r["idle_ns"].values()) / r["gap_ns"] * 100 + \
        read["outside_idle_share.edit"] == pytest.approx(100.0)
