"""Running averages and step timers (host-side).

Counterpart of sdn3d_tpu/utils/profiling.py's AverageMeter and StepTimer
(the reference's AverageMeter wall-clock timers, semantic/utils.py).  The
JAX module's `trace` is a jax.profiler scope that no CLI reaches; on the
card, torch.profiler plays its part (chip_smoke.device_time).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


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
