"""outside_idle_share.train: the share of the profiler slice's idle time
(the gaps between busy intervals) in which the host was inside none of
the port's `train.forward`, `train.backward` and `train.optimizer` spans,
in % (perfbench/harness/spans.py)."""

from perfbench.harness import spans


def read(t):
    return spans.outside_share(t)
