"""Stand-in for sdn3d_tpu_torch/parallel with no process group: the
helpers the frozen models and trainers call, at world size 1."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch


@dataclasses.dataclass
class BatchDraw:
    generator: torch.Generator
    rows: slice
    global_rows: int


def active() -> bool:
    return False


def rand_rows(shape: Sequence[int], generator, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """torch.rand(shape) from `generator`."""
    return torch.rand(tuple(shape), generator=generator, dtype=dtype,
                      device=device)


def all_reduce_autograd(t: torch.Tensor) -> torch.Tensor:
    return t


def global_count(t: torch.Tensor) -> torch.Tensor:
    return t


def global_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x)


def sum_across_ranks(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return tensors


def sum_values(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return values
