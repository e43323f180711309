"""detections_per_frame.edit: the objects the port's chain kept from its
detections (its `count.det.kept` counter, after the 16-slot cap) per edit
pair of the traced run's profiler slice: the traffic the detector's
weights make.  None where the port counts none."""

from perfbench.harness import spans


def read(t):
    r = spans.idle(t)
    if r is None or not t.get("units_prof") \
            or "count.det.kept" not in r["counts"]:
        return None
    return r["counts"]["count.det.kept"] / t["units_prof"]
