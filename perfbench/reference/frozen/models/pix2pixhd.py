# Frozen copy of sdn3d_tpu_torch/models/pix2pixhd.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Textural branch networks: pix2pixHD's global generator G, multiscale
discriminator D, instance feature encoder E, the global VAE encoder and
LocalEnhancer, NCHW.

PyTorch counterpart of sdn3d_tpu/models/pix2pixhd.py
(textural/models/networks.py).  Norm layers are instance norm without
affine parameters (pix2pixHD default), computed as the JAX package
computes it.  G and E are each one `model` Sequential with the
reference's module order, so the reference state_dict keys (`model.N.*`,
`model.N.conv_block.{1,5}.*`) map one to one; D keeps the reference's
intermediate-feature layout (`scale{i}_layer{j}.0.*`).  The per-instance
average pooling is a one-hot product over dense instance slots, both ways.

Every network gives the same bits for the same input on every run on the
card, and so does its backward under cuDNN's deterministic algorithms:
the transposed convolutions are forward convolutions of the dilated input
(`ConvTranspose`), the reflection padding is a concatenation of flipped
slices (`reflect_pad`), and nothing adds with float atomics.  Each takes a
compute dtype for its convolutions; parameters, norms, the last
discriminator layer and the losses stay float32.

3D-SDN settings (textural/options/base_options.py): ngf=64,
n_downsample_global=4, n_blocks_global=9, n_local_enhancers=0
(LocalEnhancer unused), ndf=64, num_D=2, n_layers_D=3, getIntermFeat=True,
nef=16, n_downsample_E=4, feat_num=5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.frozen.models.derenderer import strict_fp32
from perfbench.reference.frozen.models.layers import (Conv2d, ConvTranspose,
                                           set_compute_dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW: (x - mean) * rsqrt(var + eps)
    over each image's spatial dims, biased variance; computed in float32
    and cast back to the input's dtype (JAX models/pix2pixhd.py:26-29); a
    float64 input stays float64."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflection padding of the last two dims by p (F.pad's "reflect"),
    as a concatenation of flipped slices: the same copy forward, and a
    backward of slices and adds.  F.pad's CUDA backward adds with float
    atomics, so two runs of a training step would differ in the last
    bits."""
    if p == 0:
        return x
    x = torch.cat([x[..., 1:p + 1].flip(-1), x, x[..., -p - 1:-1].flip(-1)],
                  dim=-1)
    return torch.cat([x[..., 1:p + 1, :].flip(-2), x,
                      x[..., -p - 1:-1, :].flip(-2)], dim=-2)


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class Tanh(nn.Module):
    """tanh in at least float32 whatever the input's dtype (JAX
    models/pix2pixhd.py:103)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x.to(torch.promote_types(x.dtype, torch.float32)))


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


def _slot_onehot(inst_slots: torch.Tensor, max_instances: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """[B, H, W] dense slots -> the one-hot slot matrix [B, max_instances,
    H*W] in `dtype`."""
    B = inst_slots.shape[0]
    slot_ids = torch.arange(max_instances, device=inst_slots.device)
    return (inst_slots.reshape(B, 1, -1).long()
            == slot_ids[None, :, None]).to(dtype)


def _slot_means(onehot: torch.Tensor, features: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(means [B, M, F], pixel counts [B, M]) of features [B, H, W, F]
    under the one-hot slot matrix, the sums one batched product."""
    B, H, W, F_ = features.shape
    sums = torch.bmm(onehot, features.reshape(B, H * W, F_))
    counts = onehot.sum(dim=2)
    return sums / torch.clamp(counts[..., None], min=1.0), counts


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
    if features.is_cuda:
        strict_fp32()
    return _slot_means(_slot_onehot(inst_slots, max_instances,
                                    features.dtype), features)


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


def instance_average(features: torch.Tensor, inst_slots: torch.Tensor,
                     max_instances: int) -> torch.Tensor:
    """Instance-wise average pooling (networks.py:310-326; JAX
    models/pix2pixhd.py:312): every pixel's features replaced by the mean
    over its instance's pixels, per batch item.  features [B, H, W, F]
    (channels last, as the JAX package's); inst_slots [B, H, W] int in
    [0, max_instances).  One-hot products both ways: the table of
    instance_feature_means, then the per-pixel means onehot^T . table, so
    neither the forward nor the backward adds with atomics (a gather's
    backward would scatter-add)."""
    if features.is_cuda:
        strict_fp32()
    onehot = _slot_onehot(inst_slots, max_instances, features.dtype)
    means, _ = _slot_means(onehot, features)
    return torch.bmm(onehot.transpose(1, 2), means).reshape(features.shape)


class GlobalEncoder(nn.Module):
    """Global VAE encoder netGlobalE (JAX models/pix2pixhd.py:246):
    image [B, 3, H, W] -> (mu, logvar) [B, nz].  A stride-2 4x4 stem, then
    n_blocks pre-activation residual blocks, each halving the size (a
    stride-2 3x3 convolution beside a 2x2 average-pool shortcut, whose odd
    dims are padded at their end so the pool's size matches the
    convolution's, e.g. 624 -> 39 -> 20 at block 3; a 1x1 convolution on
    the shortcut where the width changes), a ReLU in float32, the global
    mean, and two float32 dense heads.  The reference names this
    convention (global_encoder_which_model='resnet_128', nef 64, nz 3) but
    never builds the module, so its parameter names are the JAX module's
    (conv_in, block{i}_conv1 / _conv2 / _skip, fc_mu, fc_logvar)."""

    def __init__(self, input_nc: int = 3, nz: int = 3, nef: int = 64,
                 n_blocks: int = 4, dtype="float32"):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv_in = Conv2d(input_nc, nef, 4, stride=2, padding=1)
        ch = nef
        for i in range(n_blocks):
            out_ch = nef * min(2 ** (i + 1), 4)
            setattr(self, f"block{i}_conv1",
                    Conv2d(ch, out_ch, 3, stride=2, padding=1))
            setattr(self, f"block{i}_conv2", Conv2d(out_ch, out_ch, 3,
                                                    padding=1))
            if ch != out_ch:
                setattr(self, f"block{i}_skip",
                        Conv2d(ch, out_ch, 1, bias=False))
            ch = out_ch
        set_compute_dtype(self, dtype)
        # the dense heads stay float32 (flax Dense without a dtype)
        self.fc_mu = nn.Linear(ch, nz)
        self.fc_logvar = nn.Linear(ch, nz)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.is_cuda:
            strict_fp32()
        y = self.conv_in(x)
        for i in range(self.n_blocks):
            h = torch.relu(instance_norm(y))
            h = getattr(self, f"block{i}_conv1")(h)
            h = torch.relu(instance_norm(h))
            h = getattr(self, f"block{i}_conv2")(h)
            s = _avg_pool_2s2_end_pad(y)
            skip = getattr(self, f"block{i}_skip", None)
            if skip is not None:
                s = skip(s)
            y = h + s
        y = torch.relu(y.to(torch.promote_types(y.dtype, torch.float32)))
        y = y.mean(dim=(2, 3))
        return self.fc_mu(y), self.fc_logvar(y)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """z = mu + exp(logvar / 2) * eps (pix2pixHD_model.py:194-196), eps a
    standard normal draw from `generator` (on mu's device)."""
    eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return mu + torch.exp(0.5 * logvar) * eps
