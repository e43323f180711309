# Frozen copy of sdn3d_tpu_torch/models/semantic.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Semantic branch: dilated ResNet-50 encoder + Pyramid Pooling decoder,
NCHW.

PyTorch counterpart of sdn3d_tpu/models/semantic.py (encoder
resnet50_dilated8 with the deep 3-conv stem, decoder ppm_bilinear_deepsup,
semantic/models.py:359-415 — the 3D-SDN default).  Module names follow the
reference state_dicts: the encoder as models/resnet.py, the PPM decoders
`ppm.K.{1,2}` (1x1 conv, BN), `conv_last.{0,1,4}` (3x3 conv, BN, 1x1
classifier) and, with deep supervision, `cbr_deepsup.{0,1}` and
`conv_last_deepsup`; the C1 decoders `cbr.{0,1}`, `conv_last` and the
same deep-supervision keys.  Both branches are here: inference (softmax
at seg_size) and training (log-probabilities at stride 8, with flax's
element-wise dropout and the deep-supervision head), with the loss and
pixel accuracy of the semantic trainer.

Resizes are computed as the JAX package computes them
(jax.image.resize(method="bilinear")): per-axis weight matrices of the
triangle kernel, widened by in/out when shrinking (anti-aliasing) and
renormalised at the edges, applied as two products.  Neither setting of
torch's `interpolate(antialias=...)` matches that for both shrinking and
enlarging.  The PPM's adaptive average pooling is two averaging products
with torch AdaptiveAvgPool2d windows.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.frozen import parallel
from perfbench.reference.frozen.models.derenderer import strict_fp32
from perfbench.reference.frozen.models.layers import (BatchNorm2d, Conv2d,
                                           set_compute_dtype)
from perfbench.reference.frozen.models.resnet import BN_EPS, resnet50_dilated8
from perfbench.reference.frozen.utils.transfer import to_device


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


class Dropout(nn.Module):
    """flax's element-wise nn.Dropout(rate) (JAX models/semantic.py:101,
    :113): in training each element is kept with probability 1 - rate and
    the kept ones are divided by 1 - rate, `select(mask, x / keep, 0)`; in
    eval mode, or at rate 0, the identity.  `draw` is the keep mask (bool,
    x's shape; the CPU tests hand over JAX's) or a torch.Generator on x's
    device to draw it from (uniform < keep, as jax.random.bernoulli
    draws; a parallel.BatchDraw draws the global batch's mask and keeps
    this rank's rows); None draws from torch's default generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, draw=None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if draw is None or isinstance(draw, (torch.Generator,
                                             parallel.BatchDraw)):
            draw = parallel.rand_rows(x.shape, draw, device=x.device) < keep
        return torch.where(draw, x / keep, x.new_zeros(()))


@contextlib.contextmanager
def _cudnn_off():
    """torch's own convolution for the span (cuDNN's other flags kept)."""
    found = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = found


class _GemmConv(torch.autograd.Function):
    """A convolution without bias whose forward and both gradients run
    torch's own convolution (cuDNN off): an unfold and a float32 product a
    sample, col2im for the input's gradient, no atomics.  `conf` is
    (stride, padding, dilation, groups)."""

    @staticmethod
    def forward(ctx, x, weight, conf):
        ctx.save_for_backward(x, weight)
        ctx.conf = conf
        with _cudnn_off():
            return F.conv2d(x, weight, None, *conf)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _cudnn_off():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, weight, None, list(stride), list(padding),
                list(dilation), False, [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


class DecoderConv2d(Conv2d):
    """The decoders' convolutions.  Training in float32 on the card they
    run torch's own convolution (_GemmConv), the bias added after, as
    flax adds it.  Most feed a train-mode BatchNorm that, over the few
    values a channel holds at a small batch (2 at the PPM's 1x1 pool),
    magnifies the rounding of its input by thousands.  cuDNN's float32
    convolutions round ~10x coarser than a float32 product (conv_last.0's
    forward sits ~9e-6 of its scale off float64 against ~1e-6), and put
    the decoder's gradients 70x further from float64 than the CPU's
    float32 at 2 x 64 x 64 (chip_smoke.py 13b prints both).  Otherwise
    (eval mode, bfloat16, the CPU) it is Conv2d."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and x.is_cuda
                and self.compute_dtype == torch.float32):
            return super().forward(x)
        y = _GemmConv.apply(x, self.weight, (self.stride, self.padding,
                                             self.dilation, self.groups))
        return y if self.bias is None else y + self.bias[:, None, None]


def _draws(dropout, n: int) -> list:
    """The draws of a decoder's n dropouts: None or one torch.Generator
    for all of them, or one keep mask each, in the order they apply."""
    if dropout is None or isinstance(dropout, (torch.Generator,
                                               parallel.BatchDraw)):
        return [dropout] * n
    draws = list(dropout)
    if len(draws) != n:
        raise ValueError(f"{len(draws)} dropout masks for {n} dropouts")
    return draws


def conv_bn_relu(c_in: int, c_out: int) -> nn.Sequential:
    """conv3x3_bn_relu (semantic/models.py; JAX ConvBNReLU): 3x3 conv
    without bias, BatchNorm, ReLU, under the reference keys `.0`, `.1`."""
    return nn.Sequential(DecoderConv2d(c_in, c_out, 3, padding=1,
                                       bias=False),
                         BatchNorm2d(c_out, eps=BN_EPS), nn.ReLU())


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Logits in float32, or float64 in a float64 run."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _outputs(x: torch.Tensor, seg_size, d: Optional[torch.Tensor] = None):
    """A decoder's outputs from its float32 logits: at inference
    (seg_size given) the softmax over classes of the logits resized to
    seg_size; else the log-softmax, with the deep-supervision head's
    beside it when the decoder has one (JAX models/semantic.py:110-117)."""
    if seg_size is not None:
        return torch.softmax(resize_bilinear(x, seg_size), dim=1)
    if d is None:
        return torch.log_softmax(x, dim=1)
    return torch.log_softmax(x, dim=1), torch.log_softmax(d, dim=1)


class PPMBilinear(nn.Module):
    """Pyramid pooling decoder without deep supervision
    (semantic/models.py:311-355; JAX models/semantic.py:152-189): conv5
    and its four pooled branches (pool, 1x1 conv, BN, ReLU, resized back)
    concatenated, 3x3 conv, BN, ReLU, element-wise dropout, 1x1
    classifier.  The classifier's logits, resize and softmax are float32.
    The reference's `conv_last` Sequential keeps its keys (`.0`, `.1`, the
    classifier `.4`); its entry 3 is the dropout, which takes a draw and
    so is called apart."""

    def __init__(self, num_class: int = 14, fc_dim: int = 2048,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout_rate: float = 0.1):
        super().__init__()
        self.ppm = nn.ModuleList([nn.Sequential(
            AdaptivePool(s), DecoderConv2d(fc_dim, 512, 1, bias=False),
            BatchNorm2d(512, eps=BN_EPS), nn.ReLU())
            for s in pool_scales])
        self.conv_last = nn.Sequential(
            DecoderConv2d(fc_dim + len(pool_scales) * 512, 512, 3,
                          padding=1, bias=False),
            BatchNorm2d(512, eps=BN_EPS), nn.ReLU(),
            Dropout(dropout_rate),
            DecoderConv2d(512, num_class, 1))

    def logits(self, conv5: torch.Tensor, draw) -> torch.Tensor:
        """The classifier's float32 logits at conv5's size."""
        hw = (conv5.shape[2], conv5.shape[3])
        ppm_out = [conv5]
        for branch in self.ppm:
            ppm_out.append(resize_bilinear(branch(conv5), hw))
        c = self.conv_last
        x = c[2](c[1](c[0](torch.cat(ppm_out, dim=1))))
        return _at_least_f32(c[4](c[3](x, draw)))

    def forward(self, conv_out: Sequence[torch.Tensor],
                seg_size: Optional[Tuple[int, int]] = None, dropout=None):
        return _outputs(self.logits(conv_out[-1], _draws(dropout, 1)[0]),
                        seg_size)


class PPMDeepsup(PPMBilinear):
    """PPMBilinearDeepsup (semantic/models.py:359-415; JAX
    models/semantic.py:69-117): PPMBilinear and, in the training branch
    (seg_size None), the deep-supervision head on conv4: 3x3 conv, BN,
    ReLU (`cbr_deepsup.{0,1}`), element-wise dropout (parameter-free),
    1x1 classifier (`conv_last_deepsup`).  Two dropouts, in this order:
    the classifier's, then the head's."""

    def __init__(self, num_class: int = 14, fc_dim: int = 2048,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout_rate: float = 0.1):
        super().__init__(num_class, fc_dim, pool_scales, dropout_rate)
        self.cbr_deepsup = conv_bn_relu(fc_dim // 2, fc_dim // 4)
        self.dropout_deepsup = Dropout(dropout_rate)
        self.conv_last_deepsup = DecoderConv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out: Sequence[torch.Tensor],
                seg_size: Optional[Tuple[int, int]] = None, dropout=None):
        d_last, d_sup = _draws(dropout, 2)
        x = self.logits(conv_out[-1], d_last)
        if seg_size is not None:
            return _outputs(x, seg_size)
        d = self.dropout_deepsup(self.cbr_deepsup(conv_out[-2]), d_sup)
        return _outputs(x, None, _at_least_f32(self.conv_last_deepsup(d)))


class C1BilinearDeepSup(nn.Module):
    """conv3x3-BN-ReLU and a 1x1 classifier (`cbr.{0,1}`, `conv_last`)
    with, when deep_sup, the same head on conv4 (`cbr_deepsup.{0,1}`,
    `conv_last_deepsup`) in the training branch
    (semantic/models.py:251-283; JAX models/semantic.py:120-149).  No
    dropout.  deep_sup False is C1Bilinear."""

    def __init__(self, num_class: int = 14, fc_dim: int = 2048,
                 deep_sup: bool = True):
        super().__init__()
        self.deep_sup = deep_sup
        self.cbr = conv_bn_relu(fc_dim, fc_dim // 4)
        self.conv_last = DecoderConv2d(fc_dim // 4, num_class, 1)
        if deep_sup:
            self.cbr_deepsup = conv_bn_relu(fc_dim // 2, fc_dim // 4)
            self.conv_last_deepsup = DecoderConv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out: Sequence[torch.Tensor],
                seg_size: Optional[Tuple[int, int]] = None, dropout=None):
        x = _at_least_f32(self.conv_last(self.cbr(conv_out[-1])))
        if seg_size is not None or not self.deep_sup:
            return _outputs(x, seg_size)
        d = _at_least_f32(self.conv_last_deepsup(self.cbr_deepsup(
            conv_out[-2])))
        return _outputs(x, None, d)


DECODERS = {
    "ppm_bilinear_deepsup": PPMDeepsup,
    "ppm_bilinear": PPMBilinear,
    "c1_bilinear_deepsup": C1BilinearDeepSup,
    "c1_bilinear": functools.partial(C1BilinearDeepSup, deep_sup=False),
}


class SemanticModel(nn.Module):
    """Encoder + decoder (SegmentationModule, semantic/models.py:24-48).
    images [B, 3, H, W] -> class probabilities [B, num_class, *seg_size]
    with seg_size; without it the decoder's log-probabilities at the
    encoder's stride 8 (a pair with deep supervision), the training
    branch.  The module's train / eval mode is JAX's `train`: BatchNorm on
    the batch's statistics (moving the running ones) and dropout with
    `dropout`'s draws (decoder.forward).  arch_decoder picks among the
    reference's decoders (ModelBuilder.build_decoder, models.py:117-147);
    the 3D-SDN default is ppm_bilinear_deepsup.  `dtype` "bfloat16" runs
    the convolutions in bfloat16 (JAX models/semantic.py:211-213);
    parameters, BatchNorm, the logits and the softmax stay float32."""

    def __init__(self, num_class: int = 14,
                 arch_decoder: str = "ppm_bilinear_deepsup",
                 dtype="float32"):
        super().__init__()
        if arch_decoder not in DECODERS:
            raise ValueError(f"decoder {arch_decoder!r}: one of "
                             f"{tuple(DECODERS)}")
        self.num_class = num_class
        self.arch_decoder = arch_decoder
        self.encoder = resnet50_dilated8()
        self.decoder = DECODERS[arch_decoder](num_class=num_class)
        set_compute_dtype(self, dtype)

    def forward(self, images: torch.Tensor,
                seg_size: Optional[Tuple[int, int]] = None, dropout=None):
        if images.is_cuda:
            strict_fp32()
        conv_out = self.encoder.stages(images)[1:]     # C2..C5
        return self.decoder(conv_out, seg_size=seg_size, dropout=dropout)
