"""b2_roofline.train: the per-face reduction's (B2, box pass and sums)
least time over its device time in the profiler slice, in %; bytes (won
pixels per image from the reference's own steps) over the HBM peak or
its adds over the float32 peak, the larger."""

from perfbench.harness.common import kernel_seconds
from perfbench.kernels import counts


def read(t):
    peaks, busy = t.get("peaks"), kernel_seconds(t["device_events"], "b2")
    if not peaks or busy is None or t.get("won_per_image") is None:
        return None
    calls = sum(1 for n, _, _ in t["device_events"]
                if "segment_kernel" in n)
    B = t["b_images"]
    won = int(t["won_per_image"] * B)
    one = counts.bound_s(counts.b2_bytes(B, t["b_faces"], t["b_size"], won),
                         counts.b2_ops(won), peaks)
    return calls * one / busy * 100.0
