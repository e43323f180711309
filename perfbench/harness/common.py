"""What every driver shares: the card, the forbidden modules, the
profiler slice's reduction (device busy time, the breakdown), the phase
slice, and the result line."""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List, Optional, Tuple

# top-level module names that may not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sdn3d_tpu")


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark "
                     "runs on a CUDA card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell "
                     f"asks for {chips}")


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def device_record(device, chips: int = 1) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


# -- the profiler slice ---------------------------------------------------

def kineto_events(prof) -> Tuple[List[Tuple[str, int, int]],
                                 List[Tuple[str, int, int]]]:
    """(device events, host events) of a finished torch.profiler run, each
    (name, start ns, end ns), read from its kineto results without
    building the profiler's tree of host operations."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), start, end))
    return dev, host


def busy_intervals(events: Iterable[Tuple[str, int, int]]
                   ) -> List[Tuple[int, int]]:
    """The union of the events' [start, end) intervals, sorted."""
    out: List[Tuple[int, int]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def trace_summary(prof, wall_s: float, top: int = 10) -> Dict:
    """busy_s (seconds in which some operation ran on the card), the
    device events, and the breakdown: the `top` device operations by
    time, and the `top` longest idle gaps inside the slice, each named by
    the shortest host operation that spans the gap's middle."""
    dev, host = kineto_events(prof)
    iv = busy_intervals(dev)
    busy_ns = sum(e - s for s, e in iv)
    by_name: Dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:])),
                  reverse=True)[:top]
    named = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        spans = [(he - hs, n) for n, hs, he in host if hs <= mid < he]
        named.append([min(spans)[1] if spans else "host", length / 1e9])
    return {"busy_s": busy_ns / 1e9, "window_s": wall_s, "device_events": dev,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": named}}


def profiled(fn, on_card: bool = True):
    """Run fn() under torch.profiler (host and card); returns (fn's
    result, the profile, host seconds from a synchronised start to a
    synchronised end)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def phase_seconds(snapshot: Dict[str, Dict[str, float]],
                  prefix: str) -> Optional[float]:
    """Seconds of the port's phase records whose names start with
    `prefix` ("sem.", "geo.", ...), None when there are none."""
    hits = [v["s"] for k, v in snapshot.items() if k.startswith(prefix)]
    return sum(hits) if hits else None


# -- kernels in the trace -------------------------------------------------

# the device functions of each hand-written kernel of the port, as the
# profiler names them (csrc/rasterize.cu, segment_face_grads.cu,
# silhouette_walk.cu)
KERNEL_FUNCTIONS = {
    "b1": ("bin_count_kernel", "bin_scan_kernel", "bin_scatter_kernel",
           "raster_binned_kernel"),
    "b2": ("won_box_kernel", "segment_kernel"),
    "b3": ("walk_faces_kernel",),
}


def kernel_seconds(events, kernel: str) -> Optional[float]:
    """Device seconds of `kernel`'s functions among the events; None when
    none ran."""
    names = KERNEL_FUNCTIONS[kernel]
    hits = [(e - s) for n, s, e in events if any(f in n for f in names)]
    return sum(hits) / 1e9 if hits else None


# -- the result -------------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Tuple[float, str]], device: Dict,
                checks: Dict[str, Tuple[float, float]],
                breakdown: Optional[Dict] = None) -> str:
    """The last line of standard output; `checks` (each compared number
    and its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": float(v), "limit": float(lim)}
                     for k, (v, lim) in checks.items()}
    return json.dumps(out)


def check_lines(checks: Dict[str, Tuple[float, float]]) -> List[str]:
    return [f"check {k}: {v!r} (limit {lim!r}) "
            f"{'ok' if v <= lim else 'FAILED'}"
            for k, (v, lim) in checks.items()]
