"""Textural branch networks: the pix2pixHD global generator G and the
instance feature encoder E, NCHW.

PyTorch counterpart of the inference networks of
sdn3d_tpu/models/pix2pixhd.py (textural/models/networks.py).  Norm layers
are instance norm without affine parameters (pix2pixHD default), computed
as the JAX package computes it.  Each network is one `model` Sequential
with the reference's module order, so the reference state_dict keys
(`model.N.*`, `model.N.conv_block.{1,5}.*`) map one to one.  The
per-instance average pooling is a one-hot product over dense instance
slots.  Both networks give the same bits for the same input on every
run on the card (the transposed convolutions are computed as forward
convolutions, `ConvTranspose`).

3D-SDN settings (textural/options/base_options.py): ngf=64,
n_downsample_global=4, n_blocks_global=9, nef=16, n_downsample_E=4,
feat_num=5.  LocalEnhancer, the discriminators and the global encoder wait
for the textural trainer (ROADMAP.md A).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from sdn3d_tpu_torch.models.derenderer import strict_fp32
from sdn3d_tpu_torch.models.layers import (Conv2d, ConvTranspose,
                                           set_compute_dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW: (x - mean) * rsqrt(var + eps)
    over each image's spatial dims, biased variance; computed in float32
    and cast back to the input's dtype (JAX models/pix2pixhd.py:26-29)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return nn.functional.pad(x, (p, p, p, p), mode="reflect")


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class Tanh(nn.Module):
    """tanh in float32 whatever the input's dtype (JAX
    models/pix2pixhd.py:103)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x.float())


class ReflectPad(nn.Module):
    def __init__(self, p: int):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, self.p)


def _conv_transpose(in_ch: int, out_ch: int) -> ConvTranspose:
    """ConvTranspose2d(3, stride 2, pad 1, output_pad 1), which the JAX
    package writes as nn.ConvTranspose(padding ((1, 2), (1, 2)),
    transpose_kernel=True) (pix2pixhd.py:92-96)."""
    return ConvTranspose(in_ch, out_ch, 3, stride=2, padding=1,
                         output_padding=1)


class ResnetBlockG(nn.Module):
    """Generator residual block, reflect padding (networks.py:245-283)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            ReflectPad(1), Conv2d(dim, dim, 3), InstanceNorm(), nn.ReLU(),
            ReflectPad(1), Conv2d(dim, dim, 3), InstanceNorm())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


def _down_up_layers(in_ch: int, width: int, n_downsampling: int,
                    body=()) -> list:
    """c7s1-width, n stride-2 convs, `body`, n mirrored deconvs."""
    layers = [ReflectPad(3), Conv2d(in_ch, width, 7), InstanceNorm(),
              nn.ReLU()]
    for i in range(n_downsampling):
        mult = 2 ** i
        layers += [Conv2d(width * mult, width * mult * 2, 3, stride=2,
                          padding=1), InstanceNorm(), nn.ReLU()]
    layers += list(body)
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        layers += [_conv_transpose(width * mult, width * mult // 2),
                   InstanceNorm(), nn.ReLU()]
    return layers


class GlobalGenerator(nn.Module):
    """c7s1-ngf, n_downsampling stride-2 convs, n_blocks resblocks,
    mirrored deconvs, c7s1-output_nc + tanh (networks.py:211-242).
    `dtype` is the convolutions' compute dtype; the instance norms
    compute in float32 and the float32 tanh returns float32."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 dtype="float32"):
        super().__init__()
        mult = 2 ** n_downsampling
        body = [ResnetBlockG(ngf * mult) for _ in range(n_blocks)]
        self.model = nn.Sequential(
            *_down_up_layers(input_nc, ngf, n_downsampling, body),
            ReflectPad(3), Conv2d(ngf, output_nc, 7), Tanh())
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, input_nc, H, W] -> [B, output_nc, H, W], frame by frame:
        oneDNN and cuDNN choose convolution algorithms by batch size, and
        a batch of 3 moved a 3x3 residual convolution's sums in the last
        bits on the CPU, so a batched fake would depend on its batch.
        Frame by frame, the batched edit chain's fakes are the serial
        chain's, bit for bit."""
        if x.is_cuda:
            strict_fp32()
        return torch.cat([self.model(x[i:i + 1]) for i in range(x.shape[0])])


class Encoder(nn.Module):
    """Instance-wise feature encoder (networks.py:286-346): image
    [B, 3, H, W] -> features [B, feat_num, H, W] in [-1, 1]."""

    def __init__(self, input_nc: int = 3, feat_num: int = 5, nef: int = 16,
                 n_downsampling: int = 4, dtype="float32"):
        super().__init__()
        self.model = nn.Sequential(
            *_down_up_layers(input_nc, nef, n_downsampling),
            ReflectPad(3), Conv2d(nef, feat_num, 7), Tanh())
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            strict_fp32()
        return self.model(x)


def instance_feature_means(features: torch.Tensor, inst_slots: torch.Tensor,
                           max_instances: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-instance mean feature table (generate_feat_dict,
    networks.py:328-346).  features [B, H, W, F] (channels last, as the
    JAX package's); inst_slots [B, H, W] int in [0, max_instances).
    Returns means [B, max_instances, F] and pixel counts
    [B, max_instances].  The sums are one batched product of a one-hot
    slot matrix [B, max_instances, H*W] with the features, so the table
    has no atomic float adds and the card gives the same bits on every
    run (the per-source caches of the edit chain rely on that)."""
    B, H, W, F = features.shape
    if features.is_cuda:
        strict_fp32()
    slot_ids = torch.arange(max_instances, device=features.device)
    onehot = (inst_slots.reshape(B, 1, H * W).long()
              == slot_ids[None, :, None]).to(features.dtype)
    sums = torch.bmm(onehot, features.reshape(B, H * W, F))
    counts = onehot.sum(dim=2)
    means = sums / torch.clamp(counts[..., None], min=1.0)
    return means, counts


def get_edges(inst: torch.Tensor) -> torch.Tensor:
    """Instance boundary map (pix2pixHD_model.py:343-349).
    inst [B, H, W] int -> float edge map [B, 1, H, W]."""
    e = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    dx = inst[:, :, 1:] != inst[:, :, :-1]
    dy = inst[:, 1:, :] != inst[:, :-1, :]
    e[:, :, 1:] |= dx
    e[:, :, :-1] |= dx
    e[:, 1:, :] |= dy
    e[:, :-1, :] |= dy
    return e[:, None].to(torch.float32)
