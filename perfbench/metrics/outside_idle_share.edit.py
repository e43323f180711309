"""outside_idle_share.edit: the share of the profiler slice's idle time
(the gaps between busy intervals) in which the host was inside no
`stage.*` span of the port: the benchmark's request loop, or program code
with no stage span, in % (perfbench/harness/spans.py)."""

from perfbench.harness import spans


def read(t):
    return spans.outside_share(t)
