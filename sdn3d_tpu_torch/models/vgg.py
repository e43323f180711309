"""VGG19 feature extractor for the perceptual loss, NCHW.

PyTorch counterpart of sdn3d_tpu/models/vgg.py (textural/models/
networks.py:467-496, the Vgg19 slices, and VGGLoss :137-153): five ReLU
taps, relu1_1 .. relu5_1, weighted 1/32, 1/16, 1/8, 1/4, 1.  The module
is torchvision's `vgg19().features` cut after relu5_1 (features.0 ..
features.29), so a torchvision state_dict's `features.N.*` keys load as
they are.  It always computes in float32 (the JAX module has no dtype),
TF32 off on the card.  With random weights the loss is a stable
multi-scale feature metric, not the paper's perceptual loss.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from sdn3d_tpu_torch.models.derenderer import strict_fp32

# torchvision vgg19.features conv layout (channels per conv, M = maxpool)
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# conv indices whose ReLU output is tapped: relu1_1, relu2_1, relu3_1,
# relu4_1, relu5_1 (features 1, 6, 11, 20, 29)
_TAPS = (0, 2, 4, 8, 12)
LOSS_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class Vgg19Features(nn.Module):
    """`features` up to relu5_1; forward returns the five taps.  Input
    [B, 3, H, W] in [-1, 1] (pix2pixHD feeds tanh outputs and normalised
    images as they are)."""

    def __init__(self):
        super().__init__()
        layers, taps, conv_idx, in_ch = [], [], 0, 3
        for c in _CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(in_ch, c, 3, padding=1), nn.ReLU()]
            if conv_idx in _TAPS:
                taps.append(len(layers) - 1)
            in_ch, conv_idx = c, conv_idx + 1
            if conv_idx > _TAPS[-1]:
                break
        self.features = nn.Sequential(*layers)
        self.taps = tuple(taps)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if x.is_cuda:
            strict_fp32()
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                out.append(x)
        return out


def vgg_loss(vgg: Vgg19Features, fake: torch.Tensor,
             real: torch.Tensor) -> torch.Tensor:
    """VGGLoss (networks.py:137-153): the weighted L1 over the five taps,
    the real image's taps without a gradient (computed under no_grad).
    fake / real [B, 3, H, W]."""
    f_fake = vgg(fake)
    with torch.no_grad():
        f_real = vgg(real)
    loss = 0.0
    for w, a, b in zip(LOSS_WEIGHTS, f_fake, f_real):
        loss = loss + w * torch.mean(torch.abs(a - b))
    return loss
