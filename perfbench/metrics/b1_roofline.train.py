"""b1_roofline.train: B1's least time over its device time in the
training steps of the profiler slice, in %: one launch a step over the
batch's silhouettes, which pass no colours and write no RGB; bytes over
the HBM peak or edge tests (face-box pairs per image, from the
reference's own steps) over the float32 peak, the larger
(perfbench/kernels/counts.py)."""

from perfbench.harness.common import kernel_seconds
from perfbench.kernels import counts


def read(t):
    peaks, busy = t.get("peaks"), kernel_seconds(t["device_events"], "b1")
    if not peaks or busy is None or t.get("b1_pairs_per_image") is None:
        return None
    calls = sum(1 for n, _, _ in t["device_events"]
                if "raster_binned_kernel" in n)
    B = t["b_images"]
    one = counts.bound_s(counts.b1_bytes(B, t["b_faces"], t["b_size"],
                                         colours=False),
                         counts.b1_ops(t["b1_pairs_per_image"] * B), peaks)
    return calls * one / busy * 100.0
