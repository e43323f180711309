"""The port's span and counter recorder (sdn3d_tpu_torch.utils.phases):
spans nest with their parents and their request's id, nothing records
while it is off, each span is a plain host event on a torch profiler's
timeline and shares its clock, and the profiled log outlives reset(),
empties when read, reports what it dropped and keeps the counters."""

import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdn3d_tpu_torch.utils import phases


@pytest.fixture(autouse=True)
def clean():
    phases.reset(False)
    phases.profiled()
    yield
    phases.reset(False)
    phases.profiled()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_nest_with_parents_and_shared_ids():
    with cpu_profile():
        with phases.phase("chain.request", 7):
            with phases.phase("stage.geometric"):
                with phases.phase("geo.render"):
                    pass
            with phases.phase("stage.textural"):
                pass
        with phases.phase("train.step", 3):
            with phases.phase("train.forward"):
                pass
        with phases.phase("loose"):
            pass
    log = phases.profiled()
    by = {s.name: s for s in log["spans"]}
    assert len(log["spans"]) == len(by) == 7 and log["dropped"] == 0
    req, step = by["chain.request"], by["train.step"]
    assert (req.parent, req.rid, step.parent, step.rid) == (0, 7, 0, 3)
    assert by["stage.geometric"].parent == by["stage.textural"].parent \
        == req.sid
    assert by["geo.render"].parent == by["stage.geometric"].sid
    assert {by[n].rid for n in ("stage.geometric", "geo.render",
                                "stage.textural")} == {7}
    assert (by["train.forward"].parent, by["train.forward"].rid) == \
        (step.sid, 3)
    assert (by["loose"].parent, by["loose"].rid) == (0, None)
    # spans close inner first, each inside its parent's interval
    assert [s.name for s in log["spans"][:4]] == [
        "geo.render", "stage.geometric", "stage.textural", "chain.request"]
    for s in log["spans"]:
        if s.parent:
            up = next(p for p in log["spans"] if p.sid == s.parent)
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


def test_nothing_records_when_off():
    span = phases.phase("stage.semantic", 1)
    assert span is phases.phase("other")          # one shared object
    with span:
        phases.count("count.encode")
        phases.add_bytes("geo.render", torch.zeros(4))
    assert phases.snapshot() == {}
    assert phases.profiled() == {"spans": [], "counts": {}, "dropped": 0}


def test_each_span_is_a_host_event_on_the_profilers_clock():
    """Each span's [start, end] brackets its kineto host event, which is
    no user annotation; the two clocks agree to well under 50 µs (the
    median distance over 20 spans: a loaded host can preempt one)."""
    with cpu_profile() as prof:
        for i in range(10):
            with phases.phase("stage.semantic", i):
                torch.ones(64, 64) @ torch.ones(64, 64)
                with phases.phase("sem.infer"):
                    torch.ones(8).sum()
    spans = {s.sid: s for s in phases.profiled()["spans"]}
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in ("stage.semantic", "sem.infer")),
                    key=lambda e: e.start_ns())
    assert len(events) == len(spans) == 20
    starts, ends = [], []
    for s, e in zip(sorted(spans.values(), key=lambda s: s.start_ns),
                    events):
        assert e.name() == s.name
        assert not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU
        starts.append(e.start_ns() - s.start_ns)
        ends.append(s.end_ns - (e.start_ns() + e.duration_ns()))
    assert min(starts) >= 0 and min(ends) >= 0
    assert statistics.median(starts) <= 50_000
    assert statistics.median(ends) <= 50_000


def test_reset_leaves_the_profiled_log_and_the_phase_records_keep_shape():
    with cpu_profile():
        with phases.phase("geo.render"):
            pass
    phases.reset(True)
    for _ in range(2):
        with phases.phase("geo.render"):
            phases.add_bytes("geo.render", torch.zeros(250, dtype=torch.uint8))
    snap = phases.snapshot()
    rec = snap["geo.render"]
    assert rec["calls"] == 2 and rec["MB"] == pytest.approx(500e-6)
    assert set(rec) == {"s", "calls", "MB", "first_s", "steady_avg_s"}
    assert rec["s"] == pytest.approx(rec["first_s"] + rec["steady_avg_s"])
    phases.reset(True)
    assert phases.snapshot() == {}
    assert [s.name for s in phases.profiled()["spans"]] == ["geo.render"]
    assert phases.profiled()["spans"] == []       # a read empties the log


def test_a_full_log_reports_what_it_dropped(monkeypatch):
    monkeypatch.setattr(phases, "LOG_CAP", 3)
    with cpu_profile():
        for _ in range(5):
            with phases.phase("x"):
                pass
    log = phases.profiled()
    assert len(log["spans"]) == 3 and log["dropped"] == 2
    assert phases.profiled() == {"spans": [], "counts": {}, "dropped": 0}


def test_counters_count():
    phases.reset(True)
    phases.count("count.cache.label.hit")
    phases.count("count.cache.label.hit", 2)
    with cpu_profile():
        phases.count("count.encode", 4)
    phases.count("count.encode")
    assert phases.snapshot() == {"count.cache.label.hit": {"n": 3},
                                 "count.encode": {"n": 5}}
    assert phases.profiled()["counts"] == {"count.encode": 4}
