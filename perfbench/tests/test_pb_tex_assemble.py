"""perfbench/metrics/tex_device_share.edit.py: the frames whose textural
conditioning was built on the device, over all frames assembled, read
from the counters of a planted span log; None where nothing counts an
assembly, as on a port that assembles on the host without counting."""

import pytest

from perfbench.harness import discovery, spans
from perfbench.tests.test_pb_spans import COUNTS, DEVICE, SPANS


@pytest.mark.parametrize("counted,share", [
    ({"count.tex.assemble.device": 40, "count.other": 40}, 100.0),
    ({"count.tex.assemble.device": 3, "count.tex.assemble.host": 1}, 75.0),
    ({"count.tex.assemble.host": 6}, 0.0),
    ({}, None)], ids=["all on the device", "mixed", "host", "a port without"])
def test_tex_device_share(counted, share):
    """Device-assembled frames over the device- and host-assembled ones
    (another counter counts no frame)."""
    t = {"device_events": DEVICE, "units_prof": 2}
    spans.idle(t, {"spans": list(SPANS), "counts": dict(COUNTS, **counted),
                   "dropped": 0})
    got = discovery.metric_reader("tex_device_share.edit").read(t)
    assert got == (pytest.approx(share) if share is not None else None)
