"""b1_roofline.edit: B1's least time over its device time in the profiler
slice, in %.  Each launch renders `images_per_b1_call` slot images of
`b1_faces` faces at `b1_size`, with the normal colours the chain's
render of normal maps passes; its least time is the larger of its bytes
over the HBM peak and its edge tests (face-box pairs per image, from the
check's renders) over the float32 peak (perfbench/kernels/counts.py).
The device time is the sum of B1's bin and raster kernels."""

from perfbench.harness.common import kernel_seconds
from perfbench.kernels import counts


def read(t):
    peaks, busy = t.get("peaks"), kernel_seconds(t["device_events"], "b1")
    if not peaks or busy is None or t.get("b1_pairs_per_image") is None:
        return None
    calls = sum(1 for n, _, _ in t["device_events"]
                if "raster_binned_kernel" in n)
    B = t["images_per_b1_call"]
    one = counts.bound_s(
        counts.b1_bytes(B, t["b1_faces"], t["b1_size"]),
        counts.b1_ops(t["b1_pairs_per_image"] * B), peaks)
    return calls * one / busy * 100.0
