"""semantic_ms.edit: seconds of the port's `sem.*` phases per edit pair in
the traced run's phase slice, in ms."""

from perfbench.harness.common import phase_seconds


def read(t):
    s = phase_seconds(t["phases"], "sem.")
    return None if s is None or not t["units_phase"] else \
        s / t["units_phase"] * 1e3
