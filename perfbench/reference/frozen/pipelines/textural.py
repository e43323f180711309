# Frozen copy of sdn3d_tpu_torch/pipelines/textural.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Textural branch: pix2pixHD edit-time generation, NCHW.

PyTorch counterpart of sdn3d_tpu/pipelines/textural.py
(textural/models/pix2pixHD_model.py: encode_input :124-166, forward
:176-246, fake_inference :248-280; textural/train.py: the G / D Adam
steps).

3D-SDN configuration (textural/options): label_nc=14, instance edge map,
feat_num=5 instance codes, 24-bin one-hot pose (+1 bg), normal map,
optional depth; LSGAN + D feature matching (lambda_feat=5) + VGG
perceptual (lambda_feat) + L1 (lambda_L1=10); Adam(2e-4, beta1=0.5);
netG input channels 14+1+5+25+3 (+1 with depth, +nz with the global
encoder) = 48.

Batches are dicts in the JAX package's layout (label, inst, inst_slots,
pose [B, H, W] int; image, normal [B, H, W, 3] float; optionally depth
[B, H, W]); the nets run NCHW.  The train state holds the nets (updated
in place) and each optimizer's count and moments as flat float32 buffers,
updated by `pipelines/derender_infer.adam_step` in optax's arithmetic
order.  On the card the forward and backward run under
`pipelines/derender.deterministic_cudnn` with TF32 off, and nothing adds
with float atomics, so two runs of an iteration give the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from perfbench.reference.frozen.models.pix2pixhd import (
    Encoder, GlobalEncoder, GlobalGenerator, get_edges, instance_average,
    instance_feature_means, reparameterize)
from perfbench.reference.frozen.utils.transfer import to_device


@dataclasses.dataclass(frozen=True)
class TexturalConfig:
    """The JAX package's TexturalConfig, field by field."""
    label_nc: int = 14
    output_nc: int = 3
    ngf: int = 64
    ndf: int = 64
    nef: int = 16
    feat_num: int = 5
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_downsample_e: int = 4
    n_layers_d: int = 3
    num_d: int = 2
    use_instance_edges: bool = True
    feat_pose: bool = True
    pose_bins: int = 24
    feat_normal: bool = True
    feat_depth: bool = False
    lambda_feat: float = 5.0
    lambda_l1: float = 10.0
    lr: float = 2e-4
    beta1: float = 0.5
    use_vgg_loss: bool = True
    max_instances: int = 64
    # the global-encoder VAE option (pix2pixHD_model.py:190-198,235-237;
    # off by default, base_options.py:65): netGlobalE maps the real image
    # to an nz-dim latent whose reparameterized sample is broadcast as nz
    # extra netG channels, and a KL term (weight lambda_kl) joins the G
    # objective
    use_global_encoder: bool = False
    global_encoder_nz: int = 3
    global_encoder_nef: int = 64
    lambda_kl: float = 0.01
    # GAN history buffer for the D fake loss (pix2pixHD_model.py:171,202;
    # 0 = pass-through, the reference default train_options.py:35)
    pool_size: int = 0
    # compute dtype of the G / D / E convolutions; parameters, norms and
    # losses stay float32
    compute_dtype: str = "float32"

    @property
    def netG_input_nc(self) -> int:
        nc = self.label_nc
        if self.use_instance_edges:
            nc += 1
        nc += self.feat_num
        if self.feat_pose:
            nc += self.pose_bins + 1
        if self.feat_normal:
            nc += 3
        if self.feat_depth:
            nc += 1
        if self.use_global_encoder:
            nc += self.global_encoder_nz   # pix2pixHD_model.py:41-42
        return nc


# Shrunken net dims for small runs (one definition shared by the train CLI
# and config_from_train_meta, so checkpoints round-trip); the JAX
# package's SMALL_NET_OVERRIDES.
SMALL_NET_OVERRIDES = dict(ngf=8, ndf=8, nef=4, n_downsample_global=2,
                           n_blocks_global=2, n_downsample_e=2,
                           n_layers_d=2, max_instances=8)


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
    parts = [one_hot_label(label_map, cfg.label_nc)]
    if cfg.use_instance_edges:
        parts.append(get_edges(inst_map))
    return torch.cat(parts, dim=1)


def assemble_generator_input(cfg: TexturalConfig, input_label: torch.Tensor,
                             feat_map: torch.Tensor,
                             pose_map: Optional[torch.Tensor],
                             normal_map: Optional[torch.Tensor],
                             depth_map: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """input_label ‖ feat_map ‖ one-hot pose ‖ normal ‖ depth, NCHW, each
    part as the config asks."""
    parts = [input_label, feat_map]
    if cfg.feat_pose:
        parts.append(one_hot_label(pose_map, cfg.pose_bins + 1))
    if cfg.feat_normal:
        parts.append(normal_map)
    if cfg.feat_depth:
        parts.append(depth_map)
    return torch.cat(parts, dim=1)


def _nchw(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A batch's channels-last map [B, H, W, C] (or a plane [B, H, W]) as
    [B, C, H, W]."""
    if x is None:
        return None
    return x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)


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
    """pix2pixHD edit-time generation (the JAX package's TexturalTrainer,
    its training taken out).  The constructor builds netG, netE and, with
    the global encoder, netGlobalE from the global generator;
    `.to(device)` moves them."""

    def __init__(self, cfg: TexturalConfig = TexturalConfig()):
        self.cfg = cfg
        self.netG = GlobalGenerator(cfg.netG_input_nc, cfg.output_nc, cfg.ngf,
                                    cfg.n_downsample_global,
                                    cfg.n_blocks_global,
                                    dtype=cfg.compute_dtype)
        self.netE = Encoder(cfg.output_nc, cfg.feat_num, cfg.nef,
                            cfg.n_downsample_e, dtype=cfg.compute_dtype)
        self.netGlobalE = (GlobalEncoder(cfg.output_nc, cfg.global_encoder_nz,
                                         cfg.global_encoder_nef,
                                         dtype=cfg.compute_dtype)
                           if cfg.use_global_encoder else None)

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {k: getattr(self, k) for k in ("netG", "netE", "netGlobalE")
                if getattr(self, k) is not None}

    @property
    def device(self) -> torch.device:
        return next(self.netG.parameters()).device

    def to(self, device) -> "TexturalTrainer":
        for k, net in self.nets().items():
            setattr(self, k, net.to(device).eval())
        return self

    def load_state_dicts(self, g_sd: Dict[str, torch.Tensor],
                         e_sd: Dict[str, torch.Tensor],
                         ge_sd: Optional[Dict[str, torch.Tensor]] = None
                         ) -> None:
        self.netG.load_state_dict(g_sd)
        self.netE.load_state_dict(e_sd)
        if ge_sd is not None:
            self.netGlobalE.load_state_dict(ge_sd)

    # -- the global encoder's conditioning ---------------------------------

    @staticmethod
    def _append_global_z(net: GlobalEncoder, g_in: torch.Tensor,
                         image: torch.Tensor,
                         generator: Optional[torch.Generator]
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Global-encoder conditioning (pix2pixHD_model.py:190-198,265-271):
        (mu, logvar) of the image [B, 3, H, W], z the reparameterized
        sample (the posterior mean without a generator) broadcast over
        H x W as extra netG channels.  The one implementation of training
        and fake_inference."""
        mu, logvar = net(image)
        z = reparameterize(mu, logvar, generator) if generator is not None \
            else mu
        B, _, H, W = g_in.shape
        zmap = z[:, :, None, None].expand(B, z.shape[1], H, W)
        return torch.cat([g_in, zmap], dim=1), mu, logvar

    # -- edit-time generation ------------------------------------------------

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
                       feat_map: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """Edit-time generation (pix2pixHD_model.py:248-280) from the
        serving batch: label, inst (the int32 map or the raw uint8 instance
        plane), inst_slots, pose, normal (float, or the uint8 PNG bytes)
        and optionally normal_valid ([B], 0 where the frame has no normal
        map), depth, and image ([B, H, W, 3], which the encoders read).
        `feat_map` is the per-slot code table [B, max_instances, feat_num]
        expanded through inst_slots, a per-pixel map [B, H, W, feat_num],
        or None (netE on the image, averaged per instance).  With the
        global encoder, z is drawn from `generator`, or is the posterior
        mean without one.  Returns the fake [B, H, W, 3] in [-1, 1].

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
        image = batch["image"].to(dev) if "image" in batch else None
        with torch.no_grad():
            if feat_map is None:
                feat = instance_average(
                    self.netE(_nchw(image)).permute(0, 2, 3, 1), slots,
                    c.max_instances).permute(0, 3, 1, 2)
            elif feat_map.dim() == 3:
                feat = torch.gather(
                    feat_map.to(dev), 1, slots.reshape(slots.shape[0], -1, 1)
                    .expand(-1, -1, c.feat_num))
                feat = feat.reshape(*slots.shape, c.feat_num).permute(0, 3, 1, 2)
            else:
                feat = _nchw(feat_map.to(dev))
            normal = batch.get("normal")
            if normal is not None:
                normal = normal.to(dev)
                if normal.dtype == torch.uint8:
                    normal = _normal_table(dev)[normal.long()]
                if "normal_valid" in batch:
                    normal = normal * batch["normal_valid"].to(dev)[
                        :, None, None, None]
            pose, depth = batch.get("pose"), batch.get("depth")
            g_in = assemble_generator_input(
                c, input_label, feat, None if pose is None else pose.to(dev),
                _nchw(normal), None if depth is None else _nchw(depth.to(dev)))
            if c.use_global_encoder:
                g_in, _, _ = self._append_global_z(
                    self.netGlobalE, g_in, _nchw(image), generator)
            return self.netG(g_in).permute(0, 2, 3, 1)
