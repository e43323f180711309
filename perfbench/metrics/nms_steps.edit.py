"""nms_steps.edit: the fixed-point steps of the port's NMS (its
`count.det.nms_steps` counter: the RPN's NMS and the per-class detection
NMS, ops/nms.nms) per edit pair of the traced run's profiler slice.
None where the port counts none."""

from perfbench.harness import spans


def read(t):
    r = spans.idle(t)
    if r is None or not t.get("units_prof") \
            or "count.det.nms_steps" not in r["counts"]:
        return None
    return r["counts"]["count.det.nms_steps"] / t["units_prof"]
