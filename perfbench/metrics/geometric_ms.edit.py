"""geometric_ms.edit: seconds of the port's `geo.*` phases per edit pair
in the traced run's phase slice, in ms."""

from perfbench.harness.common import phase_seconds


def read(t):
    s = phase_seconds(t["phases"], "geo.")
    return None if s is None or not t["units_phase"] else \
        s / t["units_phase"] * 1e3
