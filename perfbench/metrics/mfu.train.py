"""mfu.train: FLOPs of the profiler slice's training steps (one step: the
frozen reference derenderer's forward and backward at the batch, counted
on the meta device) over the slice's wall and the card's float32 peak,
in %.  FlopCounterMode counts no elementwise work and no rasterizer, so
this is a floor."""


def read(t):
    peaks = t.get("peaks")
    if not peaks or not t["units_prof"]:
        return None
    return t["flops_prof"] / t["window_s"] / peaks["float32"] * 100.0
