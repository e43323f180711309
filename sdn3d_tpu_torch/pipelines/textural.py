"""Textural branch inference: pix2pixHD edit-time generation, NCHW.

PyTorch counterpart of the inference part of
sdn3d_tpu/pipelines/textural.py (textural/models/pix2pixHD_model.py:
encode_input :124-166, fake_inference :248-280).

3D-SDN configuration (textural/options): label_nc=14, instance edge map,
feat_num=5 instance codes, 24-bin one-hot pose (+1 bg), normal map;
netG input channels = 14+1+5+25+3 = 48.  Training (the discriminators,
VGG, the losses, Adam), depth conditioning and the global-encoder option
wait for the textural trainer (ROADMAP.md A).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from sdn3d_tpu_torch.models.pix2pixhd import (
    Encoder, GlobalGenerator, get_edges, instance_feature_means)
from sdn3d_tpu_torch.utils.transfer import to_device

_TRAINER = "the textural trainer (ROADMAP.md A, the other trainers)"


@dataclasses.dataclass(frozen=True)
class TexturalConfig:
    """The architecture fields of the JAX package's TexturalConfig that
    edit-time inference reads (the 3D-SDN configuration: instance edges,
    the 24-bin pose one-hot and the normal map on; no depth, no global
    encoder), and the training fields a checkpoint's meta carries over
    (config_from_train_meta); the other training fields wait for the
    textural trainer."""
    label_nc: int = 14
    output_nc: int = 3
    ngf: int = 64
    nef: int = 16
    feat_num: int = 5
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_downsample_e: int = 4
    pose_bins: int = 24
    max_instances: int = 64
    # compute dtype of the G / E convolutions (JAX pipelines/textural.py:
    # 69-71); parameters, instance norms and outputs stay float32
    compute_dtype: str = "float32"
    # training fields read from a checkpoint's meta (the trainer's)
    lr: float = 2e-4
    use_vgg_loss: bool = True
    pool_size: int = 0

    @property
    def netG_input_nc(self) -> int:
        # one-hot label, instance edges, feature codes, pose one-hot, normal
        return self.label_nc + 1 + self.feat_num + self.pose_bins + 1 + 3


# Shrunken net dims for small runs (the JAX package's SMALL_NET_OVERRIDES,
# less its discriminator fields).
SMALL_NET_OVERRIDES = dict(ngf=8, nef=4, n_downsample_global=2,
                           n_blocks_global=2, n_downsample_e=2,
                           max_instances=8)


def config_from_train_meta(meta: dict, **overrides) -> TexturalConfig:
    """The TexturalConfig a checkpoint's nets were trained with, from its
    manifest's training meta (the JAX package's config_from_train_meta;
    the reference persists opt.txt for the same purpose,
    options/base_options.py:112-128): `small` selects SMALL_NET_OVERRIDES,
    `pool_size` and `lr` carry over, `no_vgg` sets use_vgg_loss.
    `overrides` (inference-time choices such as compute_dtype) win over
    meta.  A global-encoder checkpoint raises: GlobalEncoder is not
    ported."""
    if meta.get("use_global_encoder"):
        raise NotImplementedError(
            "use_global_encoder checkpoints: the global encoder waits for "
            "the textural trainer (ROADMAP.md A8)")
    kw = {}
    if meta.get("small"):
        kw.update(SMALL_NET_OVERRIDES)
    for k in ("pool_size", "lr"):
        if k in meta:
            kw[k] = meta[k]
    if "no_vgg" in meta:
        kw["use_vgg_loss"] = not meta["no_vgg"]
    kw.update(overrides)
    return TexturalConfig(**kw)


def one_hot_label(label_map: torch.Tensor, num_classes: int) -> torch.Tensor:
    """label_map [B, H, W] int -> one-hot [B, C, H, W] float32
    (pix2pixHD_model.py:128-132).  Shifted labels reach 14 (Vegetation,
    raw 13 + 1) while label_nc is 14: such an id gets an all-zero row, as
    jax.nn.one_hot gives it (and the reference's CUDA scatter_ with
    asserts off).  Built by comparison, since F.one_hot raises there."""
    classes = torch.arange(num_classes, device=label_map.device)
    return (label_map.long()[:, None] == classes[None, :, None, None]
            ).to(torch.float32)


def encode_input(cfg: TexturalConfig, label_map: torch.Tensor,
                 inst_map: torch.Tensor) -> torch.Tensor:
    """The conditioning stack without the feature codes: one-hot label ‖
    instance edges (pix2pixHD_model.py:124-166), [B, C, H, W]."""
    return torch.cat([one_hot_label(label_map, cfg.label_nc),
                      get_edges(inst_map)], dim=1)


def assemble_generator_input(cfg: TexturalConfig, input_label: torch.Tensor,
                             feat_map: torch.Tensor, pose_map: torch.Tensor,
                             normal_map: torch.Tensor) -> torch.Tensor:
    """input_label ‖ feat_map ‖ one-hot pose ‖ normal, NCHW."""
    return torch.cat([input_label, feat_map,
                      one_hot_label(pose_map, cfg.pose_bins + 1),
                      normal_map], dim=1)


def _normal_u8_table() -> np.ndarray:
    """byte -> (x/255 - 0.5)/0.5 + 1/255 in float32, as the JAX package's
    compiled fake_inference computes it on the CPU: XLA turns x/255 into a
    fused multiply-add with the reciprocal, fma(x, 1/255, -0.5), then
    multiplies by 2 and adds 1/255.  A table lookup gives exactly these
    values on any device."""
    x = np.arange(256, dtype=np.float64)
    recip = np.float64(np.float32(1.0) / np.float32(255.0))
    t = (x * recip - 0.5).astype(np.float32)       # one rounding, as an FMA
    return t * np.float32(2.0) + np.float32(1.0 / 255.0)


_NORMAL_U8_TABLE = _normal_u8_table()


@functools.lru_cache(maxsize=None)
def _normal_table(device: torch.device) -> torch.Tensor:
    return to_device(_NORMAL_U8_TABLE, device)


class TexturalTrainer:
    """netG (GlobalGenerator) and netE (Encoder) for edit-time inference:
    the inference surface of the JAX package's TexturalTrainer.  Build the
    nets, then `.to(device)`; weights come from load_state_dicts or are the
    nets' own initialisation."""

    def __init__(self, cfg: TexturalConfig = TexturalConfig()):
        self.cfg = cfg
        self.netG = GlobalGenerator(cfg.netG_input_nc, cfg.output_nc, cfg.ngf,
                                    cfg.n_downsample_global,
                                    cfg.n_blocks_global,
                                    dtype=cfg.compute_dtype)
        self.netE = Encoder(cfg.output_nc, cfg.feat_num, cfg.nef,
                            cfg.n_downsample_e, dtype=cfg.compute_dtype)

    @property
    def device(self) -> torch.device:
        return next(self.netG.parameters()).device

    def to(self, device) -> "TexturalTrainer":
        self.netG = self.netG.to(device).eval()
        self.netE = self.netE.to(device).eval()
        return self

    def load_state_dicts(self, g_sd: Dict[str, torch.Tensor],
                         e_sd: Dict[str, torch.Tensor]) -> None:
        self.netG.load_state_dict(g_sd)
        self.netE.load_state_dict(e_sd)

    def make_train_iteration(self, *args, **kwargs):
        raise NotImplementedError(f"training waits for {_TRAINER}")

    def encode_feat_means(self, image: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
        """netE + the per-slot mean table in one device pass (the JAX
        package's encode_feat_means_jit): image [B, H, W, 3] in [-1, 1],
        slots [B, H, W] int -> [B, max_instances, feat_num]."""
        with torch.no_grad():
            feats = self.netE(image.permute(0, 3, 1, 2))
            return instance_feature_means(feats.permute(0, 2, 3, 1), slots,
                                          self.cfg.max_instances)[0]

    def fake_inference(self, batch: Dict[str, torch.Tensor],
                       feat_map: torch.Tensor) -> torch.Tensor:
        """Edit-time generation (pix2pixHD_model.py:248-280) from the
        serving batch: label, inst (the raw uint8 instance plane),
        inst_slots, pose (uint8 [B, H, W]), normal (uint8 PNG bytes
        [B, H, W, 3]) and normal_valid ([B], 0 where the frame has no
        normal map), with `feat_map` the per-slot code table
        [B, max_instances, feat_num] expanded through inst_slots.
        Returns the fake [B, H, W, 3] in [-1, 1].

        The int32 instance map is rebuilt with assemble_condition_maps'
        integer math (background pixels carry the relabelled segm,
        instance pixels k*1000); the normal bytes are normalised through
        `_NORMAL_U8_TABLE`, and frames without a normal map condition on
        exact zeros."""
        c = self.cfg
        dev = self.device
        label = batch["label"].to(dev).long()
        inst = batch["inst"].to(dev)
        if inst.dtype == torch.uint8:
            inst = torch.where(inst == 0, label, inst.long() * 1000)
        input_label = encode_input(c, label, inst)
        slots = batch["inst_slots"].to(dev).long()
        feat = torch.gather(
            feat_map.to(dev), 1,
            slots.reshape(slots.shape[0], -1, 1).expand(-1, -1, c.feat_num))
        feat = feat.reshape(*slots.shape, c.feat_num).permute(0, 3, 1, 2)
        normal = batch["normal"].to(dev)
        if normal.dtype == torch.uint8:
            normal = _normal_table(dev)[normal.long()]
        if "normal_valid" in batch:
            normal = normal * batch["normal_valid"].to(dev)[:, None, None, None]
        g_in = assemble_generator_input(c, input_label, feat,
                                        batch["pose"].to(dev),
                                        normal.permute(0, 3, 1, 2))
        with torch.no_grad():
            return self.netG(g_in).permute(0, 2, 3, 1)
