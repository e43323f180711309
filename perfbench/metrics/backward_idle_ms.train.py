"""backward_idle_ms.train: ms a step in which the card sat idle while the host
was inside the port's `train.backward` span, over the gaps between busy
intervals in the traced run's profiler slice (perfbench/harness/spans.py)."""

from perfbench.harness import spans


def read(t):
    return spans.idle_ms_per_unit(t, "train.backward")
