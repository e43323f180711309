"""Running averages, step timers (host-side) and a trace scope.

Counterpart of sdn3d_tpu/utils/profiling.py: AverageMeter and StepTimer
(the reference's AverageMeter wall-clock timers, semantic/utils.py), and
`trace`, which is a torch.profiler scope here where the JAX package's is
a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class AverageMeter:
    """Running average (semantic/utils.py AverageMeter semantics)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += value * n
        self.count += n

    @property
    def average(self) -> float:
        return self.sum / max(self.count, 1)


class StepTimer:
    """Per-stage step timing with running averages."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.meters.setdefault(name, AverageMeter()).update(
                time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return {k: m.average for k, m in self.meters.items()}


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace scope; no-op when log_dir is None.

    Records CPU activity and, when a card is present, CUDA activity, and
    writes a Chrome trace (trace_<pid>_<µs>.json) under log_dir on exit;
    view it in chrome://tracing or Perfetto."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns() // 1000}.json"))
