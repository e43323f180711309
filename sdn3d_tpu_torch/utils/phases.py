"""Per-phase wall-clock + transfer-byte accounting.

Counterpart of sdn3d_tpu/utils/phases.py.  Each phase records wall
seconds, call count and the host<->device bytes it moved.  Off by default
and zero-cost when off.  When enabled, device-phase callers route results
through `block()`, which synchronises the card, so a phase's wall time
includes the device work it launched (this serialises phases that could
otherwise overlap: the breakdown is for attribution).

Usage:
    from sdn3d_tpu_torch.utils import phases
    with phases.phase("geo.render"):
        out = phases.block(fn(x))          # synchronise iff profiling
    phases.add_bytes("geo.fetch", arr)     # count a host fetch
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch

enabled = False
_LOCK = threading.Lock()
# name -> [seconds, calls, bytes, first_call_seconds]
_TIMES: Dict[str, List[float]] = {}


def reset(on: bool = True) -> None:
    global enabled
    with _LOCK:
        _TIMES.clear()
        enabled = on


@contextlib.contextmanager
def phase(name: str):
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            rec = _TIMES.setdefault(name, [0.0, 0, 0, 0.0])
            if rec[1] == 0:
                rec[3] = dt          # first call carries one-time set-up
            rec[0] += dt
            rec[1] += 1


def block(tree):
    """torch.cuda.synchronize() iff profiling and the card is in use (so
    instrumented phases charge their own device work instead of the next
    fetch).  Returns `tree` unchanged."""
    if enabled and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    try:
        return int(x.size) * int(x.dtype.itemsize)
    except AttributeError:
        return 0


def add_bytes(name: str, *arrays) -> None:
    """Attribute transfer volume (either direction) to a phase."""
    if not enabled:
        return
    n = sum(_nbytes(a) for a in arrays)
    with _LOCK:
        rec = _TIMES.setdefault(name, [0.0, 0, 0, 0.0])
        rec[2] += n


def snapshot() -> Dict[str, Dict[str, float]]:
    """first_s isolates the first call; steady_avg_s is the per-call mean
    over the remaining calls (the serving rate)."""
    with _LOCK:
        out = {}
        for k, v in sorted(_TIMES.items()):
            rec = {"s": v[0], "calls": v[1], "MB": v[2] / 1e6}
            if v[1] > 1:
                rec["first_s"] = v[3]
                rec["steady_avg_s"] = (v[0] - v[3]) / (v[1] - 1)
            out[k] = rec
        return out
