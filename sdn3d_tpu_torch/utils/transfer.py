"""Copies between the host and the card that do not wait for the card
(the JAX package's `copy_to_host_async` / `device_put`).

`HostFetch(t)` starts copying a device tensor into pinned host memory
without waiting for it, and `result()` waits for that copy alone and
returns the bytes as numpy.  Three things keep it correct:
  * the host buffer is pinned: a non-blocking copy into pageable memory
    silently waits for the device;
  * `result()` waits on an event recorded after the copy: a pinned buffer
    read before the copy has landed holds stale bytes, not an error;
  * the handle keeps the source tensor until then, so the caching
    allocator cannot hand its memory to later work while the copy reads
    it.
A CPU tensor needs no copy: `result()` returns it at once.  `to_device`
is the other direction (`to_device_packed` for several arrays in one
copy), and `constant` keeps small constants on the card so that they are
uploaded once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


class HostFetch:
    """One device tensor on its way to the host."""

    def __init__(self, t: torch.Tensor):
        self._src = None
        self._event = None
        if t.is_cuda:
            self._src = t
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    @property
    def nbytes(self) -> int:
        return self._host.numel() * self._host.element_size()

    def result(self) -> np.ndarray:
        """The tensor's values, once the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._src = None
        return self._host.numpy()


def to_device(a, device) -> torch.Tensor:
    """A host array (or CPU tensor) on `device` without waiting for the
    card: copied into pinned memory, then a non-blocking copy.  torch's
    blocking copy from pageable memory synchronises the stream first, so
    every such upload waits for all the work queued before it, and a
    pipelined caller could not run ahead of the card.  The caching host
    allocator keeps the pinned block until the copy has read it."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.require(a, requirements=("C", "W")))     # torch wants writable
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def to_device_packed(arrays, device) -> list:
    """Host arrays on `device` in ONE non-blocking copy: their bytes laid
    out in a pinned buffer, each at a 16-byte offset, and one typed view
    of the device buffer an array (same dtypes and shapes).  One copy
    costs one launch and one pinned block where `to_device` an array
    costs one of each."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 16) * 16
    dev = torch.device(device)
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    flat = host.numpy()
    for a, off in zip(arrays, offsets):
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
    return [buf[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .reshape(a.shape) for a, off in zip(arrays, offsets)]


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor (a tuple of numbers, or of tuples) on
    `device`, uploaded once; callers must not write into it."""
    return to_device(torch.tensor(values, dtype=dtype), device)

