"""ResNet-18 trunk (torchvision layout) for the derenderer encoder.

PyTorch counterpart of the BasicBlock / ResNet / ResNetClassifier path of
sdn3d_tpu/models/resnet.py (torchvision resnet18,
derender3d/models/derenderer.py:28).  Module names follow torchvision
(`conv1`, `bn1`, `layerI.J.*`, `downsample.0/1`, `fc`) so the reference's
state_dict maps one to one.  Padding is explicit and symmetric, as the
JAX package writes it; BatchNorm uses eps 1e-5 and, in eval mode, its
running statistics.  The semantic branch's Bottleneck / dilated trunk
waits for the semantic slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-5


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, filters, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or in_ch != filters:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, filters, 1, stride=stride, bias=False),
                nn.BatchNorm2d(filters, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk (7x7 stem, max pool, four stages), NCHW."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for i, (blocks, f) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            layer = []
            for j in range(blocks):
                stride = (1 if i == 0 else 2) if j == 0 else 1
                layer.append(BasicBlock(in_ch, f, stride=stride))
                in_ch = f
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.num_features = in_ch

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] -> the last stage's features."""
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class ResNetClassifier(ResNet):
    """ResNet trunk + global average pool + fc (torchvision resnet18 shape)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_outputs: int = 256):
        super().__init__(stage_sizes)
        self.fc = nn.Linear(self.num_features, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] (NCHW) -> [B, num_outputs]."""
        x = self.features(x).mean(dim=(2, 3))      # adaptive avgpool -> 1
        return self.fc(x)
