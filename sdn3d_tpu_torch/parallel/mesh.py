"""Data parallelism over torch.distributed, one process a card.

PyTorch counterpart of sdn3d_tpu/parallel/mesh.py.  The JAX package puts
the batch on a 1-D device mesh: the leading axis is sharded, the
parameters replicated, XLA inserts the collectives, and flax's BatchNorm
then reduces over the whole sharded batch (synchronised BatchNorm).  Here
each card is a process of a process group started by torchrun
(`python -m torch.distributed.run --nproc_per_node N -m <cli> ...`), and
the trainers do by hand what XLA does:

  - each rank takes its slice of the global batch (`local_batch_slice`,
    `shard_batch`); `check_world_divides` is `make_mesh_for_batch`'s
    counterpart: a process group cannot shrink, so a world size that does
    not divide the batch raises;
  - every draw of a step covers the global batch from the same generator
    and each rank keeps its rows (`BatchDraw`, `rand_rows`), so the draws
    do not depend on the world size;
  - a loss is this rank's numerator over the all-reduced denominator
    (`global_count`, `global_mean`), so the sum over the ranks of the
    losses, and of their gradients (`sum_across_ranks`), is the global
    batch's;
  - BatchNorm all-reduces its per-channel sums (`all_reduce_autograd`,
    models/layers.BatchNorm2d);
  - rank 0's initial weights are broadcast (`broadcast_module`: the role
    of `replicated_sharding`).

Without a process group every helper is the identity, and the trainers
run the single-process path unchanged.  A group of size 1 (torchrun
--nproc_per_node 1) runs the collectives.

Multi-host: torchrun numbers the ranks node-major (rank = node *
local_world_size + local_rank), which is the JAX package's (hosts, data)
mesh flattened; `make_multihost_mesh` reads that layout and
`multihost_batch_sharding` is the rank's slice of the global batch, the
same as `local_batch_slice`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

def active() -> bool:
    """Whether a process group is initialised in this process."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def in_launcher() -> bool:
    """Whether torchrun (or another launcher with its environment) started
    this process: WORLD_SIZE and RANK are set."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize_multihost(device: Union[str, torch.device],
                         backend: Optional[str] = None,
                         init_method: str = "env://",
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         timeout_s: float = 600.0) -> torch.device:
    """Initialise the process group (JAX `initialize_multihost`) and
    return the device this rank computes on.

    The backend follows the trainer's device: NCCL for a CUDA device, gloo
    for the CPU; `backend` overrides that only when the caller names it
    (two ranks that share one card must use gloo, since NCCL refuses
    them).  With the default init_method the rank, world size and
    rendezvous come from torchrun's environment; a CUDA device becomes
    cuda:LOCAL_RANK.  Idempotent: with a group already up it returns the
    device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device")
        torch.cuda.set_device(device)
    if active():
        return device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return device


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if active():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group's layout: this process's global rank, the world
    size, and its place on its node (torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE)."""
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int

    @property
    def node(self) -> int:
        return self.rank // self.local_world_size

    @property
    def nodes(self) -> int:
        return self.world_size // self.local_world_size


def make_mesh() -> Mesh:
    """The current group's layout (1 process when there is no group)."""
    n = world_size()
    return Mesh(rank(), n, int(os.environ.get("LOCAL_RANK", rank())),
                int(os.environ.get("LOCAL_WORLD_SIZE", n)))


def make_multihost_mesh() -> Mesh:
    """JAX's (hosts, data) mesh: the global rank over nodes x local
    ranks, node-major as torchrun assigns it."""
    return make_mesh()


def check_world_divides(batch_size: int) -> int:
    """Raise ValueError unless the world size divides the global batch;
    returns the per-rank batch.  (JAX `make_mesh_for_batch` shrinks its
    mesh to the largest divisor instead; a process group cannot.)"""
    n = world_size()
    if batch_size % n:
        fit = max(d for d in range(1, n + 1) if batch_size % d == 0)
        raise ValueError(
            f"world size {n} does not divide the global batch {batch_size}; "
            f"the largest world size up to {n} that does is {fit}")
    return batch_size // n


def local_batch_slice(global_batch_size: int) -> slice:
    """This rank's slice of the global batch (the DistributedSampler
    role: each rank loads only its slice)."""
    per = check_world_divides(global_batch_size)
    i = rank()
    return slice(i * per, (i + 1) * per)


def multihost_batch_sharding(mesh: Mesh, global_batch_size: int) -> slice:
    """The slice of `mesh.rank` in the global batch, hosts major."""
    per = global_batch_size // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch, global_batch_size: Optional[int] = None):
    """This rank's rows of a batch (a tensor, an array, or a dict or list
    of them, each with the global batch on its leading axis).  Without a
    group, the batch itself."""
    if not active():
        return batch

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rows(v) for v in x)
        return x[local_batch_slice(global_batch_size or len(x))]

    return rows(batch)


@dataclasses.dataclass
class BatchDraw:
    """A step's generator whose draws cover the global batch: a draw of
    [B_local, ...] draws [global_rows, ...] from `generator` and keeps the
    rows `rows`.  World size 1 and world size N then draw the same numbers
    for the same sample."""
    generator: torch.Generator
    rows: slice
    global_rows: int


def rand_rows(shape: Sequence[int], generator, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """torch.rand(shape) from `generator` (a torch.Generator or None), or
    this rank's rows of a global draw when it is a BatchDraw."""
    if isinstance(generator, BatchDraw):
        n = generator.rows.stop - generator.rows.start
        if shape[0] != n:
            raise ValueError(f"a draw of {shape[0]} rows for a slice of {n}")
        full = torch.rand((generator.global_rows,) + tuple(shape[1:]),
                          generator=generator.generator, dtype=dtype,
                          device=device)
        return full[generator.rows]
    return torch.rand(tuple(shape), generator=generator, dtype=dtype,
                      device=device)


def global_draw(generator: torch.Generator, global_rows: int):
    """The step's generator as the trainers take it: a BatchDraw of this
    rank's rows under a group, the generator itself without one."""
    if not active():
        return generator
    return BatchDraw(generator, local_batch_slice(global_rows), global_rows)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the sum over the ranks of
    the gradients (as torch.distributed.nn.functional.all_reduce)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


def all_reduce_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable: its backward sums
    the gradients over the ranks.  Without a group, `t` itself."""
    if not active():
        return t
    return _AllReduceSum.apply(t)


@torch.no_grad()
def global_count(t: torch.Tensor) -> torch.Tensor:
    """The sum of a count over the ranks, with no gradient (a loss's
    denominator).  Without a group, `t` itself."""
    if not active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's part of the mean over the global batch: sum(x) over
    the all-reduced element count; torch.mean(x) without a group."""
    if not active():
        return torch.mean(x)
    n = global_count(torch.tensor(float(x.numel()), dtype=x.dtype,
                                  device=x.device))
    return torch.sum(x) / n


@torch.no_grad()
def sum_across_ranks(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum a list of tensors (a flat gradient) over the ranks in one
    collective on one flat buffer; views of that buffer come back.
    Without a group, the list itself."""
    if not active():
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    return [c.view(t.shape) for c, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def sum_values(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalars summed over the ranks in one collective (each rank's part
    of a global loss -> the global loss)."""
    if not active() or not values:
        return values
    keys = list(values)
    flat = sum_across_ranks([values[k].detach().reshape(1) for k in keys])
    return {k: v.reshape(()) for k, v in zip(keys, flat)}


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from rank `src` (the
    replicated initial state)."""
    if not active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)
