"""Textural branch: pix2pixHD training and edit-time generation, NCHW.

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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdn3d_tpu_torch.models.derenderer import strict_fp32
from sdn3d_tpu_torch.models.pix2pixhd import (
    Encoder, GlobalEncoder, GlobalGenerator, MultiscaleDiscriminator,
    feature_matching_loss, gan_loss_lsgan, get_edges, instance_average,
    instance_feature_means, kl_loss, reparameterize)
from sdn3d_tpu_torch.models.vgg import Vgg19Features, vgg_loss
from sdn3d_tpu_torch.pipelines.derender import deterministic_cudnn
from sdn3d_tpu_torch.pipelines.derender_infer import adam_step
from sdn3d_tpu_torch.utils.image_pool import DeviceImagePool, ImagePool
from sdn3d_tpu_torch.utils.transfer import to_device


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

    @property
    def netD_input_nc(self) -> int:
        nc = self.label_nc + self.output_nc
        if self.use_instance_edges:
            nc += 1
        return nc


# Shrunken net dims for small runs (one definition shared by the train CLI
# and config_from_train_meta, so checkpoints round-trip); the JAX
# package's SMALL_NET_OVERRIDES.
SMALL_NET_OVERRIDES = dict(ngf=8, ndf=8, nef=4, n_downsample_global=2,
                           n_blocks_global=2, n_downsample_e=2,
                           n_layers_d=2, max_instances=8)


def config_from_train_meta(meta: dict, **overrides) -> TexturalConfig:
    """The TexturalConfig a checkpoint's nets were trained with, from its
    manifest's training meta (the vars(args) cli/textural_train persists;
    the JAX package's config_from_train_meta; the reference persists
    opt.txt for the same purpose, options/base_options.py:112-128):
    `small` selects SMALL_NET_OVERRIDES, `use_global_encoder`, `pool_size`
    and `lr` carry over, `no_vgg` sets use_vgg_loss.  `overrides`
    (inference-time choices such as compute_dtype) win over meta."""
    kw = {}
    if meta.get("small"):
        kw.update(SMALL_NET_OVERRIDES)
    for k in ("use_global_encoder", "pool_size", "lr"):
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


@dataclasses.dataclass
class AdamState:
    """One optimizer's state: the update count and the first and second
    moments as flat float32 buffers in its parameters' order."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor

    @classmethod
    def zeros(cls, params: List[torch.Tensor]) -> "AdamState":
        n = sum(p.numel() for p in params)
        dev = params[0].device
        return cls(0, torch.zeros(n, device=dev), torch.zeros(n, device=dev))

    def by_name(self, named) -> Dict[str, object]:
        """{"count", "mu", "nu"}, the moments by parameter name."""
        out = {"count": torch.tensor(self.count)}
        sizes = [p.numel() for _, p in named]
        for k, buf in (("mu", self.mu), ("nu", self.nu)):
            out[k] = {n: c.view(p.shape) for (n, p), c in
                      zip(named, buf.split(sizes))}
        return out

    @classmethod
    def from_names(cls, fields: Dict[str, object], named) -> "AdamState":
        dev = named[0][1].device
        mu, nu = (torch.cat([fields[k][n].reshape(-1).float()
                             for n, _ in named]).to(dev)
                  for k in ("mu", "nu"))
        return cls(int(fields["count"]), mu, nu)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             lr: float, b1: float) -> None:
        """One Adam step (optax.adam(lr, b1, b2=0.999)) on `params`, in
        place, as one flat buffer."""
        p = torch.cat([x.reshape(-1) for x in params])
        g = torch.cat([x.reshape(-1) for x in grads])
        self.count += 1
        p, self.mu, self.nu = adam_step(p, g, self.mu, self.nu, self.count,
                                        lr, b1=b1)
        torch._foreach_copy_(params, [c.view(x.shape) for c, x in zip(
            p.split([x.numel() for x in params]), params)])


@dataclasses.dataclass
class TexturalState:
    """The trainer's state (JAX TexturalState): the step, the nets, VGG,
    and the G optimizer (over netG, netE and netGlobalE, which rides it as
    at JAX pipelines/textural.py:238) and the D optimizer."""
    step: int
    netG: GlobalGenerator
    netE: Encoder
    netD: MultiscaleDiscriminator
    vgg: Vgg19Features
    opt_g: AdamState
    opt_d: AdamState
    netGlobalE: Optional[GlobalEncoder] = None

    def g_named(self) -> List[Tuple[str, torch.Tensor]]:
        """The G optimizer's parameters, named "netG.*", "netE.*",
        "netGlobalE.*"."""
        nets = [("netG", self.netG), ("netE", self.netE)]
        if self.netGlobalE is not None:
            nets.append(("netGlobalE", self.netGlobalE))
        return [(f"{k}.{n}", p) for k, net in nets
                for n, p in net.named_parameters()]

    def d_named(self) -> List[Tuple[str, torch.Tensor]]:
        return list(self.netD.named_parameters())

    def fields(self) -> Dict[str, object]:
        """The checkpoint fields of a train-state step (core/checkpoint):
        netG, netE, netD, vgg and (with the global encoder) netGlobalE
        state_dicts, opt_g / opt_d ({"count", "mu", "nu"}, the moments by
        parameter name) and step."""
        out = {"netG": self.netG.state_dict(), "netE": self.netE.state_dict(),
               "netD": self.netD.state_dict(), "vgg": self.vgg.state_dict()}
        if self.netGlobalE is not None:
            out["netGlobalE"] = self.netGlobalE.state_dict()
        out["opt_g"] = self.opt_g.by_name(self.g_named())
        out["opt_d"] = self.opt_d.by_name(self.d_named())
        out["step"] = torch.tensor(self.step)
        return out

    def load_fields(self, fields: Dict[str, object]) -> "TexturalState":
        """Load a restored step (or utils/port.textural_train_state_from_jax)
        into this state's nets and optimizers; returns the state."""
        for k in ("netG", "netE", "netD", "vgg", "netGlobalE"):
            net = getattr(self, k)
            if net is not None:
                net.load_state_dict(fields[k])
        self.opt_g = AdamState.from_names(fields["opt_g"], self.g_named())
        self.opt_d = AdamState.from_names(fields["opt_d"], self.d_named())
        self.step = int(fields["step"])
        return self


class TexturalTrainer:
    """pix2pixHD training and edit-time generation (the JAX package's
    TexturalTrainer).  The constructor builds netG, netE and, with the
    global encoder, netGlobalE from the global generator (a caller draws
    them inside torch.random.fork_rng); `.to(device)` moves them; `init`
    adds the discriminator and VGG, drawn from its generator, and the
    optimizers' zero moments."""

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
        self.netD = self.vgg = None
        self.fake_pool = ImagePool(cfg.pool_size)

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {k: getattr(self, k) for k in ("netG", "netE", "netGlobalE",
                                               "netD", "vgg")
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

    def init(self, generator: Optional[torch.Generator] = None,
             height: int = 192, width: int = 624) -> TexturalState:
        """Step 0: the nets as they are, a multiscale discriminator and
        VGG19 drawn from `generator` (torch's initialisers under a seed
        taken from it), zero moments.  height and width are the JAX
        signature's; torch's modules need no shape to build."""
        c = self.cfg
        seed = int(torch.randint(2 ** 62, (), generator=generator))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            netD = MultiscaleDiscriminator(c.netD_input_nc, c.ndf,
                                           c.n_layers_d, c.num_d,
                                           dtype=c.compute_dtype)
            vgg = Vgg19Features()
        dev = self.device
        self.netD = netD.to(dev).eval()
        self.vgg = vgg.to(dev).eval().requires_grad_(False)
        state = TexturalState(step=0, netG=self.netG, netE=self.netE,
                              netD=self.netD, vgg=self.vgg, opt_g=None,
                              opt_d=None, netGlobalE=self.netGlobalE)
        state.opt_g = AdamState.zeros([p for _, p in state.g_named()])
        state.opt_d = AdamState.zeros([p for _, p in state.d_named()])
        return state

    # -- the forward ----------------------------------------------------

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        dev = self.device
        return {k: (v.to(dev) if isinstance(v, torch.Tensor)
                    else to_device(np.ascontiguousarray(v), dev))
                for k, v in batch.items()}

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

    def _generate(self, state: TexturalState, b: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None):
        """(fake [B, 3, H, W], input_label [B, C, H, W], (mu, logvar) or
        (None, None)) from a device batch, through the state's nets (JAX
        _generate)."""
        c = self.cfg
        input_label = encode_input(c, b["label"], b["inst"])
        image = _nchw(b["image"])
        feats = state.netE(image)
        feat_map = instance_average(feats.permute(0, 2, 3, 1),
                                    b["inst_slots"], c.max_instances)
        g_in = assemble_generator_input(
            c, input_label, feat_map.permute(0, 3, 1, 2), b.get("pose"),
            _nchw(b.get("normal")), _nchw(b.get("depth")))
        mu = logvar = None
        if c.use_global_encoder:
            g_in, mu, logvar = self._append_global_z(state.netGlobalE, g_in,
                                                     image, generator)
        return state.netG(g_in), input_label, (mu, logvar)

    # -- the two halves of an iteration -----------------------------------

    def g_gradients(self, state: TexturalState, b: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    keep_real: bool = False):
        """The G objective's gradients in state.g_named()'s parameters
        (JAX g_step's loss_fn): (grads, losses, fake, input_label,
        pred_real).  D sees the real pair once; with `keep_real` its
        features keep their graph in D's parameters for the D half (D is
        not updated in between, so they are the D half's own)."""
        c = self.cfg
        if b["image"].is_cuda:
            strict_fp32()
        named = state.g_named()
        with deterministic_cudnn():
            fake, input_label, (mu, logvar) = self._generate(state, b,
                                                             generator)
            image = _nchw(b["image"])
            real_concat = torch.cat([input_label, image], dim=1)
            if keep_real:
                pred_real = state.netD(real_concat)
            else:
                with torch.no_grad():
                    pred_real = state.netD(real_concat)
            pred_fake = state.netD(torch.cat([input_label, fake], dim=1))
            loss_gan = gan_loss_lsgan(pred_fake, True)
            loss_feat = feature_matching_loss(pred_fake, pred_real, c.num_d,
                                              c.n_layers_d, c.lambda_feat)
            loss_l1 = c.lambda_l1 * torch.mean(torch.abs(fake - image))
            loss_vgg = torch.zeros((), device=fake.device)
            if c.use_vgg_loss:
                loss_vgg = c.lambda_feat * vgg_loss(state.vgg, fake, image)
            total = loss_gan + loss_feat + loss_l1 + loss_vgg
            losses = {"G_GAN": loss_gan, "G_GAN_Feat": loss_feat,
                      "G_L1": loss_l1, "G_VGG": loss_vgg}
            if c.use_global_encoder:
                loss_kl = c.lambda_kl * kl_loss(mu, logvar)
                total = total + loss_kl
                losses["E_VAE"] = loss_kl
            grads = torch.autograd.grad(total, [p for _, p in named],
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(named, grads)]
        return (grads, {k: v.detach() for k, v in losses.items()},
                fake.detach(), input_label, pred_real)

    def d_gradients(self, state: TexturalState, fake_concat: torch.Tensor,
                    real_concat: Optional[torch.Tensor] = None,
                    pred_real=None):
        """The D objective's gradients in D's parameters (JAX d_step's
        loss_fn, 0.5 (fake + real)): (grads, losses).  The real pair's
        features are `pred_real` (with their graph) when given, else D on
        `real_concat`."""
        if fake_concat.is_cuda:
            strict_fp32()
        params = [p for _, p in state.d_named()]
        with deterministic_cudnn():
            pred_fake = state.netD(fake_concat.detach())
            if pred_real is None:
                pred_real = state.netD(real_concat)
            l_fake = gan_loss_lsgan(pred_fake, False)
            l_real = gan_loss_lsgan(pred_real, True)
            grads = torch.autograd.grad(0.5 * (l_fake + l_real), params)
        return list(grads), {"D_fake": l_fake.detach(),
                             "D_real": l_real.detach()}

    def apply_g(self, state: TexturalState, grads) -> None:
        state.opt_g.step([p for _, p in state.g_named()], grads, self.cfg.lr,
                         self.cfg.beta1)

    def apply_d(self, state: TexturalState, grads) -> None:
        state.opt_d.step([p for _, p in state.d_named()], grads, self.cfg.lr,
                         self.cfg.beta1)

    # -- the steps ------------------------------------------------------

    def make_g_step(self):
        """g_step(state, batch, generator=None) -> (state, losses): the
        generator (+ encoders) update (train.py:86-90).  `generator` draws
        the global encoder's z and is required with it."""
        def g_step(state, batch, generator=None):
            if self.cfg.use_global_encoder and generator is None:
                # training on the posterior mean while the KL term pulls
                # (mu, logvar) toward N(0, 1) is a silent VAE bug; the mean
                # is for inference only (fake_inference)
                raise ValueError(
                    "g_step requires a generator when cfg.use_global_encoder")
            grads, losses, *_ = self.g_gradients(state, self._batch(batch),
                                                 generator)
            self.apply_g(state, grads)
            state.step += 1
            return state, losses
        return g_step

    def make_d_step(self):
        """d_step(state, batch, generator=None, fake_concat=None) ->
        (state, losses): the discriminator update (train.py:92-95).
        `fake_concat` ([B, netD_input_nc, H, W]) is a precomputed, possibly
        history-pooled conditioning ‖ fake stack (pooled_fake_concat); when
        None the current G output is used."""
        def d_step(state, batch, generator=None, fake_concat=None):
            if (self.cfg.use_global_encoder and fake_concat is None
                    and generator is None):
                raise ValueError(
                    "d_step requires a generator when cfg.use_global_encoder "
                    "and no precomputed fake_concat is given")
            b = self._batch(batch)
            with torch.no_grad(), deterministic_cudnn():
                if fake_concat is None:
                    fake, input_label, _ = self._generate(state, b, generator)
                    fake_concat = torch.cat([input_label, fake], dim=1)
                else:
                    input_label = encode_input(self.cfg, b["label"], b["inst"])
            image = _nchw(b["image"])
            grads, losses = self.d_gradients(
                state, fake_concat, torch.cat([input_label, image], dim=1))
            self.apply_d(state, grads)
            return state, losses
        return d_step

    def device_pool(self, height: int, width: int) -> DeviceImagePool:
        """The device history pool for this config's conditioning ‖ fake
        stack [netD_input_nc, H, W]."""
        return DeviceImagePool.create(
            self.cfg.pool_size, (self.cfg.netD_input_nc, height, width),
            device=self.device)

    def make_train_iteration(self):
        """One training iteration (the CLI's path; JAX
        make_train_iteration, train.py:61-95 + pix2pixHD_model.py:176-246):
        one forward makes the fake; the G objective updates netG / netE /
        netGlobalE; the detached conditioning ‖ fake stack, through the
        history pool when one is given, and the real pair (D's features
        of it from the G half, D unchanged since) update D.

        iteration(state, batch, generator=None, pool=None) -> (state,
        losses, pool).  `generator` draws the global encoder's z and the
        pool's decisions, and is required with either."""
        def iteration(state, batch, generator=None, pool=None):
            if self.cfg.use_global_encoder and generator is None:
                raise ValueError("train_iteration requires a generator when "
                                 "cfg.use_global_encoder")
            if pool is not None and generator is None:
                raise ValueError("train_iteration requires a generator when "
                                 "a history pool is used")
            b = self._batch(batch)
            grads, g_losses, fake, input_label, pred_real = self.g_gradients(
                state, b, generator, keep_real=True)
            self.apply_g(state, grads)
            fake_concat = torch.cat([input_label, fake], dim=1)
            if pool is not None:
                fake_concat = pool.query(fake_concat, generator)
            grads_d, d_losses = self.d_gradients(state, fake_concat,
                                                 pred_real=pred_real)
            self.apply_d(state, grads_d)
            state.step += 1
            return state, {**g_losses, **d_losses}, pool
        return iteration

    def pooled_fake_concat(self, state: TexturalState, batch,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """The conditioning ‖ fake stack through the host history pool
        (the use_pool path of the reference's discriminate(),
        pix2pixHD_model.py:168-174); pass it to d_step as fake_concat."""
        b = self._batch(batch)
        with torch.no_grad(), deterministic_cudnn():
            fake, input_label, _ = self._generate(state, b, generator)
        concat = torch.cat([input_label, fake], dim=1).cpu().numpy()
        return to_device(self.fake_pool.query(concat), self.device)

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
