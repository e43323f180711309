"""perfbench/metrics/render_graph_share.edit.py: the re-renders on the card
that replayed their shape key's CUDA graph, over all re-renders on the card,
read from the counters of a planted span log; None where nothing counts a
render, as on a port without the graph."""

import pytest

from perfbench.harness import discovery, spans
from perfbench.tests.test_pb_spans import COUNTS, DEVICE, SPANS


@pytest.mark.parametrize("counted,share", [
    ({"count.render_graph.eager": 2, "count.render_graph.capture": 2,
      "count.render_graph.replay": 38}, 95.0),
    ({"count.render_graph.replay": 5}, 100.0),
    ({"count.render_graph.eager": 1}, 0.0),
    ({}, None)], ids=["warm", "all replays", "eager", "a port without"])
def test_render_graph_share(counted, share):
    """Replays over the CUDA re-renders (replays and eager runs; a capture
    is no render of its own)."""
    t = {"device_events": DEVICE, "units_prof": 2}
    spans.idle(t, {"spans": list(SPANS), "counts": dict(COUNTS, **counted),
                   "dropped": 0})
    got = discovery.metric_reader("render_graph_share.edit").read(t)
    assert got == (pytest.approx(share) if share is not None else None)
