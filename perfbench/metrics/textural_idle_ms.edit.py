"""textural_idle_ms.edit: ms a pair in which the card sat idle while the host
was inside a `stage.textural` span of the port, over the gaps between busy
intervals in the traced run's profiler slice (perfbench/harness/spans.py)."""

from perfbench.harness import spans


def read(t):
    return spans.idle_ms_per_unit(t, "stage.textural")
