"""LPIPS perceptual distance (Zhang et al. 2018), VGG16 variant.

PyTorch counterpart of sdn3d_tpu/models/lpips.py:

  d(x, y) = sum_l  mean_hw  || |w_l| * (norm(f_l(x)) - norm(f_l(y))) ||^2

with f_l the five VGG16 relu taps (relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3), norm() the unit normalisation over channels, w_l the per-channel
linear weights, and the official scaling layer in front.  Module names
follow the official `lpips` package's state_dict (`net.slice{s}.{i}.*`
with torchvision's vgg16.features index i, `lin{k}.model.1.weight`
[1, C, 1, 1], `scaling_layer.shift/scale`), so an official checkpoint
loads into `LPIPS` as it is (utils/metrics.load_lpips).  Without one the
backbone is random (init_lpips), a deterministic but uncalibrated
perceptual distance.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from sdn3d_tpu_torch.models.derenderer import strict_fp32

# torchvision vgg16.features conv layout ("M" = 2x2 max pool)
_CFG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]
TAP_CHANNELS = (64, 128, 256, 512, 512)
# the official package's slices: features[0:4], [4:9], [9:16], [16:23],
# [23:30], each ending on a tapped relu
_SLICE_ENDS = (4, 9, 16, 23, 30)

# input scaling layer of the official implementation
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _vgg16_features() -> List[nn.Module]:
    """torchvision's vgg16.features[0:30] (to relu5_3)."""
    layers: List[nn.Module] = []
    in_ch = 3
    for c in _CFG16:
        if c == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_ch, c, 3, padding=1), nn.ReLU()]
            in_ch = c
    return layers


class Vgg16Features(nn.Module):
    """The five LPIPS relu taps of VGG16, NCHW input (already scaled)."""

    def __init__(self):
        super().__init__()
        layers = _vgg16_features()
        start = 0
        for s, end in enumerate(_SLICE_ENDS, 1):
            sl = nn.Sequential()
            for i in range(start, end):
                sl.add_module(str(i), layers[i])
            setattr(self, f"slice{s}", sl)
            start = end

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for s in range(1, len(_SLICE_ENDS) + 1):
            x = getattr(self, f"slice{s}")(x)
            taps.append(x)
        return taps


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        for name, v in (("shift", _SHIFT), ("scale", _SCALE)):
            self.register_buffer(name, torch.tensor(v).reshape(1, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """The official lin head: dropout (identity in eval) + 1x1 conv; only
    its weight is read, as |w| per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


def _unit_normalize(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit normalisation over channels (dim 1)."""
    norm = torch.sqrt(torch.sum(t ** 2, dim=1, keepdim=True))
    return t / (norm + eps)


class LPIPS(nn.Module):
    """Backbone taps -> unit norm -> per-channel |w| -> spatial mean ->
    sum over layers.  forward(x, y) on NCHW in [-1, 1] returns [B]."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = Vgg16Features()
        for k, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(c))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            strict_fp32()
        fx = self.net(self.scaling_layer(x))
        fy = self.net(self.scaling_layer(y))
        total = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = getattr(self, f"lin{k}").model[1].weight.reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(diff * torch.abs(w), dim=1),
                                       dim=(1, 2))
        return total


def init_lpips(seed: int = 0, device="cuda") -> LPIPS:
    """LPIPS in eval mode on `device` with a random backbone drawn from
    `seed` inside torch.random.fork_rng (the global generator is left as
    it was) and unit linear weights, as the JAX package initialises its
    heads.  Not the JAX package's PRNGKey(0) backbone: the two random
    metrics differ (ROADMAP.md C)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LPIPS()
    for k in range(len(TAP_CHANNELS)):
        nn.init.ones_(getattr(model, f"lin{k}").model[1].weight)
    return model.to(device).eval()


def lpips(model: LPIPS, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per batch item; x, y NHWC in [-1, 1] (the JAX
    package's layout), on the model's device."""
    with torch.no_grad():
        return model(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
