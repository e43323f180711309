# Frozen copy of sdn3d_tpu_torch/models/resnet.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""ResNet family (torchvision / semantic-branch layout), NCHW.

PyTorch counterpart of sdn3d_tpu/models/resnet.py, with its builders:
  * torchvision resnet18 (BasicBlock, 7x7 stem): the derenderer encoder
    (derender3d/models/derenderer.py:28), `resnet18_feature`;
  * dilated resnet50 (Bottleneck, deep 3-conv stem, output stride 8): the
    semantic encoder (semantic/resnet.py:104-132, semantic/models.py:
    183-247), `resnet50_dilated8`;
  * torchvision resnet101 (Bottleneck, 7x7 stem), `resnet101`.
Module names follow the reference state_dicts (`conv1`, `bn1`, [`conv2`,
`bn2`, `conv3`, `bn3` for the deep stem], `layerI.J.*`,
`downsample.0/1`, `fc`), so they map one to one.  Padding is explicit and
symmetric, as the JAX package writes it; BatchNorm uses eps 1e-5 and, in
eval mode, its running statistics.  `dtype` (float32 or bfloat16) is the
convolutions' and the fc's compute dtype, as the JAX package's `dtype`
(models/layers.py: BatchNorm stays float32, so a block's output is
float32).  Mask R-CNN's caffe-style ResNet-101 (stride on the 1x1 conv1,
biases, BatchNorm eps 1e-3) is models/maskrcnn.py's own.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from perfbench.reference.frozen.models.layers import (BatchNorm2d, Conv2d, Linear,
                                           set_compute_dtype)

BN_EPS = 1e-5


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, filters, 3, stride=stride,
                            padding=dilation, dilation=dilation,
                            bias=False)
        self.bn1 = BatchNorm2d(filters, eps=BN_EPS)
        self.conv2 = Conv2d(filters, filters, 3, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(filters, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or in_ch != filters:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, filters, 1, stride=stride, bias=False),
                BatchNorm2d(filters, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride and dilation here, torchvision "B") -> 1x1 x4."""
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        out = filters * 4
        self.conv1 = Conv2d(in_ch, filters, 1, bias=False)
        self.bn1 = BatchNorm2d(filters, eps=BN_EPS)
        self.conv2 = Conv2d(filters, filters, 3, stride=stride,
                            padding=dilation, dilation=dilation,
                            bias=False)
        self.bn2 = BatchNorm2d(filters, eps=BN_EPS)
        self.conv3 = Conv2d(filters, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or in_ch != out:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out, 1, stride=stride, bias=False),
                BatchNorm2d(out, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk, NCHW.  `stages(x)` returns (C1, .., C5).

    output_stride 8 turns the strides of layer3/4 into dilations
    (semantic/models.py:213-226 `_nostride_dilate`): the first block of a
    stage gets `first_dilations`, the rest `dilations`.  deep_stem: three
    3x3 convs (64, 64, 128 channels) instead of the 7x7 stem
    (semantic/resnet.py:104-132)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block_cls=BasicBlock, output_stride: int = 32,
                 deep_stem: bool = False):
        super().__init__()
        self.deep_stem = deep_stem
        if deep_stem:
            self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
            self.bn1 = BatchNorm2d(64, eps=BN_EPS)
            self.conv2 = Conv2d(64, 64, 3, padding=1, bias=False)
            self.bn2 = BatchNorm2d(64, eps=BN_EPS)
            self.conv3 = Conv2d(64, 128, 3, padding=1, bias=False)
            self.bn3 = BatchNorm2d(128, eps=BN_EPS)
            in_ch = 128
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = BatchNorm2d(64, eps=BN_EPS)
            in_ch = 64
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        strides, dilations, first_dilations = (1, 2, 2, 2), (1,) * 4, (1,) * 4
        if output_stride == 8:
            strides, dilations, first_dilations = ((1, 2, 1, 1), (1, 1, 2, 4),
                                                   (1, 1, 1, 2))
        elif output_stride != 32:
            raise ValueError(f"output_stride {output_stride}: 8 or 32")
        for i, (blocks, f) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            layer = []
            for j in range(blocks):
                layer.append(block_cls(
                    in_ch, f, stride=strides[i] if j == 0 else 1,
                    dilation=first_dilations[i] if j == 0 else dilations[i]))
                in_ch = f * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.num_features = in_ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, 3, H, W] -> (C1, C2, C3, C4, C5), as JAX ResNet.__call__."""
        return self.stages(x)

    def stages(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, 3, H, W] -> (C1, C2, C3, C4, C5)."""
        x = torch.relu(self.bn1(self.conv1(x)))
        if self.deep_stem:
            x = torch.relu(self.bn2(self.conv2(x)))
            x = torch.relu(self.bn3(self.conv3(x)))
        feats = [x]
        x = self.maxpool(x)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            feats.append(x)
        return tuple(feats)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] -> the last stage's features."""
        return self.stages(x)[-1]


class ResNetClassifier(ResNet):
    """ResNet trunk + global average pool + fc (torchvision resnet18
    shape); the fc's output is float32 whatever the compute dtype."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_outputs: int = 256, dtype="float32"):
        super().__init__(stage_sizes)
        self.fc = Linear(self.num_features, num_outputs)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] (NCHW) -> [B, num_outputs] in float32 (float64 in
        a float64 run)."""
        x = self.features(x).mean(dim=(2, 3))      # adaptive avgpool -> 1
        x = self.fc(x)
        return x.to(torch.promote_types(x.dtype, torch.float32))


def resnet50_dilated8(dtype="float32") -> ResNet:
    return set_compute_dtype(ResNet(stage_sizes=(3, 4, 6, 3),
                                    block_cls=Bottleneck, output_stride=8,
                                    deep_stem=True), dtype)
