"""detect_idle_ms.edit: ms a pair in which the card sat idle while the host
was inside a `stage.detect` span of the port, over the gaps between busy
intervals in the traced run's profiler slice (perfbench/harness/spans.py).
None where the port counted no detection (`count.det.kept`): a port
without the span, or a request that brought its objects."""

from perfbench.harness import spans


def read(t):
    r = spans.idle(t)
    if r is None or "count.det.kept" not in r["counts"]:
        return None
    return spans.idle_ms_per_unit(t, "stage.detect")
