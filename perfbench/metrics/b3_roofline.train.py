"""b3_roofline.train: the silhouette walk's (B3) least time over its
device time in the profiler slice, in %.  Its bound counts bytes only
(perfbench/kernels/counts.b3_bytes): a floor of the least time, so this
share is a floor too."""

from perfbench.harness.common import kernel_seconds
from perfbench.kernels import counts


def read(t):
    peaks, busy = t.get("peaks"), kernel_seconds(t["device_events"], "b3")
    if not peaks or busy is None or t.get("b_faces") is None:
        return None
    calls = sum(1 for n, _, _ in t["device_events"]
                if "walk_faces_kernel" in n)
    one = counts.bound_s(counts.b3_bytes(t["b_images"], t["b_faces"],
                                         t["b_size"]), 0.0, peaks)
    return calls * one / busy * 100.0
