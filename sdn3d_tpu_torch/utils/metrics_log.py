"""Scalar metrics logging (PyTorch port of sdn3d_tpu/utils/metrics_log.py;
replaces tensorboardX writers: bulb/net.py:49-58,
textural/util/visualizer.py): a JSONL stream, one record a step."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self.path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self.t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "t": round(time.time() - self.t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def read_all(self):
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
