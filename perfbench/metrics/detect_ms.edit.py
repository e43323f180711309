"""detect_ms.edit: seconds of the port's `det.detect` phases (the
detection's outer phase, over `det.mold`, `det.net` and `det.unmold`,
which the phase records also keep, so they are not added again) per edit
pair in the traced run's phase slice, in ms.  None where no detection
ran."""

from perfbench.harness.common import phase_seconds


def read(t):
    s = phase_seconds(t["phases"], "det.detect")
    return None if s is None or not t["units_phase"] else \
        s / t["units_phase"] * 1e3
