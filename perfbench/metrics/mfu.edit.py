"""mfu.edit: FLOPs of the work the profiler slice's requests needed (each
request its generator; each that missed the per-source caches its
semantic pass, encode and source features besides, counted on the frozen
reference), over the slice's wall and the card's float32 peak, in %.
FlopCounterMode counts no elementwise work and no rasterizer, so this is
a floor."""


def read(t):
    peaks = t.get("peaks")
    if not peaks or not t["units_prof"]:
        return None
    return t["flops_prof"] / t["window_s"] / peaks["float32"] * 100.0
