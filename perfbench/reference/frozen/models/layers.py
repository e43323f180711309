# Frozen copy of sdn3d_tpu_torch/models/layers.py at commit 48e7a10, the package name
# rewritten; part of the benchmark's plain reference.  Do not edit.
"""Layers with a compute dtype, cast where the JAX package's flax modules
cast.

flax's `nn.Conv(dtype=bfloat16)` / `nn.Dense(dtype=bfloat16)` cast the
input and the float32 parameters to bfloat16, convolve, and add the bias
in bfloat16; the output is bfloat16.  BatchNorm is built
`dtype=float32`, so a bfloat16 input is cast up and its output is
float32 (sdn3d_tpu/models/resnet.py:102-112).  torch's autocast casts at
other points (its batch_norm on a bfloat16 input returns bfloat16), so
the port casts by hand: `Conv2d` and `Linear` compute in their
`compute_dtype` (float32 unless `set_compute_dtype` says otherwise, and
then exactly nn.Conv2d / nn.Linear), `BatchNorm2d` returns float32.
Parameters stay float32 and keep the reference state_dict keys.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.frozen import parallel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """"float32" / "bfloat16" (or a torch dtype) -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in DTYPES.values():
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"compute dtype {dtype!r}: one of {tuple(DTYPES)}")
    return DTYPES[dtype]


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, dtype: torch.dtype,
           **kw) -> torch.Tensor:
    """F.conv2d in `dtype`: the input and weight cast, the bias added in
    `dtype` after the convolution (flax's order).  float32 is F.conv2d as
    it is."""
    if dtype == torch.float32:
        return F.conv2d(x, weight, bias, **kw)
    y = F.conv2d(x.to(dtype), weight.to(dtype), None, **kw)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.compute_dtype,
                      stride=self.stride, padding=self.padding,
                      dilation=self.dilation, groups=self.groups)


class Linear(nn.Linear):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class ConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d with the reference's parameters ([in, out, kh, kw]),
    computed as the JAX package's lax.conv_transpose(transpose_kernel=True)
    computes it: a forward convolution of the input dilated by the stride
    (zeros between the pixels) and padded (k - 1 - p) before and
    (k - 1 - p + output_padding) after, with the kernel flipped and its
    in/out axes swapped.  On the card cuDNN's forward convolutions give the
    same bits on every run; the backward-data algorithms behind torch's
    transposed convolution add with atomics, so the same input would move
    the output's last bits from run to run.  Computes in `compute_dtype`,
    as Conv2d."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        lo_h, lo_w = kh - 1 - self.padding[0], kw - 1 - self.padding[1]
        if lo_h < 0 or lo_w < 0 or self.dilation != (1, 1) or self.groups != 1:
            raise ValueError("ConvTranspose: padding <= kernel - 1, no "
                             "dilation or groups")
        hd, wd = (H - 1) * sh + 1, (W - 1) * sw + 1
        z = x.new_zeros(B, C, 2 * lo_h + hd + self.output_padding[0],
                        2 * lo_w + wd + self.output_padding[1])
        z[:, :, lo_h:lo_h + hd:sh, lo_w:lo_w + wd:sw] = x
        return conv2d(z, self.weight.flip(2, 3).transpose(0, 1), self.bias,
                      self.compute_dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm in at least float32 whatever its input's dtype (flax's
    force_float32_reductions: a bfloat16 input is cast up, a float64
    one stays).

    In eval mode it is torch's batch_norm over the running statistics.  In
    train mode it computes as flax's nn.BatchNorm (use_fast_variance,
    flax/linen/normalization.py `_compute_stats`, `_normalize`): the
    batch variance as E[x^2] - E[x]^2 clipped at 0, in at least float32;
    the output (x - mean) * (rsqrt(var + eps) * weight) + bias; and the
    running statistics move by flax's momentum (1 - torch's) towards the
    batch mean and the *biased* variance (torch's own rule takes the
    unbiased one, n/(n-1) larger).

    Under a process group (parallel/mesh.py) the train-mode statistics are
    the global batch's, as flax's over a sharded batch: each rank
    all-reduces its per-channel sum(x), sum(x*x) and count in one
    differentiable collective, and every rank forms the same mean and
    biased variance from the sums (so every rank's running statistics are
    the same bits).  torch's nn.SyncBatchNorm moves the running variance
    towards the unbiased variance, and is not this."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return super().forward(x)
        if parallel.active():
            C = x.shape[1]
            n = x.new_full((1,), x.numel() // C)
            sums = parallel.all_reduce_autograd(torch.cat(
                [x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), n]))
            mean = sums[:C] / sums[2 * C]
            var = torch.clamp_min(sums[C:2 * C] / sums[2 * C] - mean * mean,
                                  0.0)
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
        if self.track_running_stats:
            keep = 1.0 - self.momentum           # flax's momentum
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean
                                        + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var
                                       + (1.0 - keep) * var)
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


def set_compute_dtype(module: nn.Module,
                      dtype: Union[str, torch.dtype]) -> nn.Module:
    """Set the compute dtype of every layer under `module` that has one
    (Conv2d, Linear, ConvTranspose).  Returns `module`."""
    dt = as_dtype(dtype)
    for m in module.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dt
    return module
