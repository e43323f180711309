"""GAN history buffer (textural/util/image_pool.py:6-32).

PyTorch counterpart of sdn3d_tpu/utils/image_pool.py.  `ImagePool` is the
host version, numpy arrays and numpy's RandomState(seed), whose draws are
the JAX package's bit for bit.  `DeviceImagePool` keeps the buffer on the
device with the same per-sample sequential semantics, its decisions drawn
from a torch.Generator.  The 3D-SDN configuration uses pool_size 0
(train_options.py:35), a pass-through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.RandomState(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        """images [B, ...] -> same-shaped batch, possibly from history."""
        if self.pool_size == 0:
            return images
        out = []
        for img in images:
            if len(self.images) < self.pool_size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.rand() > 0.5:
                idx = self.rng.randint(len(self.images))
                out.append(self.images[idx].copy())
                self.images[idx] = img.copy()
            else:
                out.append(img)
        return np.stack(out)


class DeviceImagePool:
    """Device-resident history buffer, ImagePool.query's semantics sample
    by sample (JAX utils/image_pool.py:42-98): while the buffer fills,
    append and return the input; once full, with probability 1/2 return a
    uniformly drawn historical entry and store the input in its place,
    else return the input.  The fill count is known on the host (it does
    not depend on a draw); each decision is a pair of device tensors from
    `draw`, and the buffer is updated by a one-hot select, so a query
    needs no host round trip and adds nothing with atomics."""

    def __init__(self, pool_size: int, shape, dtype=torch.float32,
                 device=None):
        self.pool_size = pool_size
        self.buf = torch.zeros((pool_size,) + tuple(shape), dtype=dtype,
                               device=device)
        self.n = 0

    @classmethod
    def create(cls, pool_size: int, shape, dtype=torch.float32,
               device=None) -> "DeviceImagePool":
        return cls(pool_size, shape, dtype, device)

    def draw(self, generator: Optional[torch.Generator]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One full-buffer decision: (use the history, a 0-d bool;
        its index in [0, n), a 0-d int64), on the buffer's device."""
        dev = self.buf.device
        use = torch.rand((), generator=generator, device=dev) > 0.5
        idx = torch.randint(0, max(self.n, 1), (), generator=generator,
                            device=dev)
        return use, idx

    def query(self, images: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """images [B, ...] -> the same-shaped batch; updates the buffer."""
        if self.pool_size == 0:
            return images
        rows = torch.arange(self.pool_size, device=self.buf.device)
        out = []
        for img in images.to(self.buf.dtype):
            if self.n < self.pool_size:
                self.buf[self.n] = img
                self.n += 1
                out.append(img)
                continue
            use, idx = self.draw(generator)
            sel = (rows == idx).reshape((-1,) + (1,) * img.dim())
            old = self.buf.index_select(0, idx.reshape(1))[0]
            out.append(torch.where(use, old, img))
            self.buf = torch.where(sel & use, img, self.buf)
        return torch.stack(out).to(images.dtype)
