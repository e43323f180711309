"""Semantic branch: dilated ResNet-50 encoder + Pyramid Pooling decoder,
NCHW.

PyTorch counterpart of sdn3d_tpu/models/semantic.py (encoder
resnet50_dilated8 with the deep 3-conv stem, decoder ppm_bilinear_deepsup,
semantic/models.py:359-415 — the 3D-SDN default).  Module names follow the
reference state_dicts: the encoder as models/resnet.py, the decoder
`ppm.K.{1,2}` (1x1 conv, BN), `conv_last.{0,1,4}` (3x3 conv, BN, 1x1
classifier), `cbr_deepsup.{0,1}` and `conv_last_deepsup`.  Only the
inference branch runs here; the deep-supervision head keeps its
parameters so converted weights load, and training waits for the
semantic trainer.

Resizes are computed as the JAX package computes them
(jax.image.resize(method="bilinear")): per-axis weight matrices of the
triangle kernel, widened by in/out when shrinking (anti-aliasing) and
renormalised at the edges, applied as two products.  Neither setting of
torch's `interpolate(antialias=...)` matches that for both shrinking and
enlarging.  The PPM's adaptive average pooling is two averaging products
with torch AdaptiveAvgPool2d windows.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sdn3d_tpu_torch.models.derenderer import strict_fp32
from sdn3d_tpu_torch.models.layers import (BatchNorm2d, Conv2d,
                                           set_compute_dtype)
from sdn3d_tpu_torch.models.resnet import BN_EPS, resnet50_dilated8
from sdn3d_tpu_torch.utils.transfer import to_device


def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] averaging matrix with torch AdaptiveAvgPool2d windows."""
    A = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)  # ceil
        A[i, start:end] = 1.0 / (end - start)
    return A


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of jax.image.resize's triangle kernel
    (jax/_src/image/scale.py compute_weight_mat, antialias=True, as XLA
    compiles it), in float32: sample positions
    (o + 0.5) / scale - 0.5, kernel widened by max(1/scale, 1), each output
    row renormalised to sum 1 (zero where the sum is ~0), rows whose sample
    lies outside the input zeroed."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    # XLA computes (o + 0.5) * inv_scale - 0.5 as one fused multiply-add
    # (the product of two float32 is exact in float64) and the division by
    # kernel_scale as a product with its reciprocal
    centres = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
    sample = (centres.astype(np.float64) * np.float64(inv_scale)
              - 0.5).astype(np.float32)
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
         * (np.float32(1.0) / kernel_scale))
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)     # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, np.float32(0.0))
    return np.ascontiguousarray(w.T.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _device_matrix(kind: str, in_size: int, out_size: int,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A resize ("resize") or pooling ("pool") matrix on the device,
    uploaded once per shape (callers must not write into it)."""
    a = (_resize_matrix if kind == "resize" else _adaptive_pool_matrix)(
        in_size, out_size)
    return to_device(a, device).to(dtype)


def _matrix(kind: str, in_size: int, out_size: int,
            like: torch.Tensor) -> torch.Tensor:
    return _device_matrix(kind, in_size, out_size, like.dtype, like.device)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """x [B, C, H, W] -> [B, C, oh, ow] (torch AdaptiveAvgPool2d windows),
    rows then columns, as two products."""
    A = _matrix("pool", x.shape[2], out_hw[0], x)
    Bm = _matrix("pool", x.shape[3], out_hw[1], x)
    x = torch.einsum("oh,bchw->bcow", A, x)
    return torch.einsum("pw,bcow->bcop", Bm, x)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] bilinear resize with half-pixel centres, as
    jax.image.resize(method="bilinear") computes it (anti-aliased when
    shrinking); an axis whose size does not change is left as it is."""
    H, W = x.shape[2], x.shape[3]
    if out_hw[0] != H:
        x = torch.einsum("oh,bchw->bcow",
                         _matrix("resize", H, out_hw[0], x), x)
    if out_hw[1] != W:
        x = torch.einsum("pw,bchw->bchp",
                         _matrix("resize", W, out_hw[1], x), x)
    return x


class AdaptivePool(nn.Module):
    """The PPM branch's pooling (index 0 of each `ppm.K` Sequential)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool2d(x, (self.size, self.size))


class PPMDeepsup(nn.Module):
    """PPMBilinearDeepsup (semantic/models.py:359-415).  The inference
    branch (JAX models/semantic.py:110-113): conv5 and its four pooled
    branches (pool, 1x1 conv, BN, ReLU, resized back) concatenated, 3x3
    conv, BN, ReLU, dropout (identity in eval), 1x1 classifier, resized to
    seg_size, softmax over classes."""

    def __init__(self, num_class: int = 14, fc_dim: int = 2048,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout_rate: float = 0.1):
        super().__init__()
        self.ppm = nn.ModuleList([nn.Sequential(
            AdaptivePool(s), Conv2d(fc_dim, 512, 1, bias=False),
            BatchNorm2d(512, eps=BN_EPS), nn.ReLU())
            for s in pool_scales])
        self.conv_last = nn.Sequential(
            Conv2d(fc_dim + len(pool_scales) * 512, 512, 3, padding=1,
                   bias=False),
            BatchNorm2d(512, eps=BN_EPS), nn.ReLU(),
            nn.Dropout2d(dropout_rate),
            Conv2d(512, num_class, 1))
        # deep supervision head (models.py:404-408): training only
        self.cbr_deepsup = nn.Sequential(
            Conv2d(fc_dim // 2, fc_dim // 4, 3, padding=1, bias=False),
            BatchNorm2d(fc_dim // 4, eps=BN_EPS), nn.ReLU())
        self.conv_last_deepsup = Conv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out: Sequence[torch.Tensor],
                seg_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if seg_size is None:
            raise NotImplementedError(
                "the deep-supervision training branch waits for the semantic "
                "trainer (ROADMAP.md A, the other trainers)")
        conv5 = conv_out[-1]
        hw = (conv5.shape[2], conv5.shape[3])
        ppm_out = [conv5]
        for branch in self.ppm:
            ppm_out.append(resize_bilinear(branch(conv5), hw))
        # the classifier's logits, resize and softmax in float32
        x = self.conv_last(torch.cat(ppm_out, dim=1)).float()
        return torch.softmax(resize_bilinear(x, seg_size), dim=1)


class SemanticModel(nn.Module):
    """Encoder + decoder (SegmentationModule, semantic/models.py:24-48).
    images [B, 3, H, W] -> class probabilities [B, num_class, *seg_size].
    `dtype` "bfloat16" runs the convolutions in bfloat16 (JAX
    models/semantic.py:211-213); parameters, BatchNorm, the logits and
    the softmax stay float32."""

    def __init__(self, num_class: int = 14,
                 arch_decoder: str = "ppm_bilinear_deepsup",
                 dtype="float32"):
        super().__init__()
        if arch_decoder != "ppm_bilinear_deepsup":
            raise NotImplementedError(
                f"decoder {arch_decoder}: only ppm_bilinear_deepsup is "
                "ported (ROADMAP.md A, the rest of the surface)")
        self.num_class = num_class
        self.encoder = resnet50_dilated8()
        self.decoder = PPMDeepsup(num_class=num_class)
        set_compute_dtype(self, dtype)

    def forward(self, images: torch.Tensor,
                seg_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if images.is_cuda:
            strict_fp32()
        conv_out = self.encoder.stages(images)[1:]     # C2..C5
        return self.decoder(conv_out, seg_size=seg_size)
