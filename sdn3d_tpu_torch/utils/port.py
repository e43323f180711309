"""flax variables -> PyTorch state_dicts (the reference's key layouts).

The exact inverses of sdn3d_tpu/utils/port.py's port_derenderer,
port_semantic, port_global_generator, port_encoder, port_lpips and
port_maskrcnn, so
weights trained or ported on the JAX side load one to one into the port's
models, and a derenderer train state (weights, running statistics, Adam's
moments and count) carries across to the port's trainer:

  conv        [kh, kw, I, O] -> [O, I, kh, kw]
  conv_transpose [kh, kw, O, I] (transpose_kernel) -> [I, O, kh, kw]
  dense       [I, O]         -> [O, I]
  batchnorm   scale/bias -> weight/bias; batch_stats mean/var ->
              running_mean/running_var (num_batches_tracked = 0)
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(dst: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    """Conv and, with transpose_kernel, ConvTranspose: both kernels go
    [kh, kw, a, b] -> [b, a, kh, kw] (JAX utils/port.py t_conv, t_convT)."""
    dst[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                            (3, 2, 0, 1)))
    if "bias" in p:
        dst[f"{name}.bias"] = _t(p["bias"])


def _linear(dst: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    dst[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    dst[f"{name}.bias"] = _t(p["bias"])


def _bn(dst: Dict[str, torch.Tensor], name: str, p: Mapping,
        s: Mapping) -> None:
    dst[f"{name}.weight"] = _t(p["scale"])
    dst[f"{name}.bias"] = _t(p["bias"])
    dst[f"{name}.running_mean"] = _t(s["mean"])
    dst[f"{name}.running_var"] = _t(s["var"])
    dst[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _resnet_trunk(sd: Dict[str, torch.Tensor], prefix: str, P: Mapping,
                  S: Mapping, stage_sizes, n_convs: int,
                  deep_stem: bool) -> None:
    """flax ResNet params/batch_stats -> torch keys under `prefix`
    (inverse of JAX utils/port.py:_port_resnet_trunk)."""
    for c in (("conv1", "conv2", "conv3") if deep_stem else ("conv1",)):
        bn = c.replace("conv", "bn")
        _conv(sd, f"{prefix}{c}", P[c])
        _bn(sd, f"{prefix}{bn}", P[bn], S[bn])
    for i, blocks in enumerate(stage_sizes):
        for j in range(blocks):
            src = f"layer{i + 1}_{j}"
            dst = f"{prefix}layer{i + 1}.{j}"
            bp, bs = P[src], S[src]
            for k in range(1, n_convs + 1):
                _conv(sd, f"{dst}.conv{k}", bp[f"conv{k}"])
                _bn(sd, f"{dst}.bn{k}", bp[f"bn{k}"], bs[f"bn{k}"])
            if "downsample_conv" in bp:
                _conv(sd, f"{dst}.downsample.0", bp["downsample_conv"])
                _bn(sd, f"{dst}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])


def derenderer_state_dict_from_jax(variables: Mapping,
                                   stage_sizes=(2, 2, 2, 2)
                                   ) -> Dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree (numpy arrays) of the JAX
    Derenderer -> torch state_dict with the reference key layout
    (net.conv1, net.bn1, net.layerI.J.*, net.fc, fc1, fc2, _fc3)."""
    P = variables["params"]
    S = variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet_trunk(sd, "net.", P["net"]["trunk"], S["net"]["trunk"],
                  stage_sizes, n_convs=2, deep_stem=False)
    _linear(sd, "net.fc", P["net"]["fc"])
    _linear(sd, "fc1", P["fc1"])
    _linear(sd, "fc2", P["fc2"])
    _linear(sd, "_fc3", P["fc3"])
    return sd


def derender_train_state_from_jax(state, stage_sizes=(2, 2, 2, 2)
                                  ) -> Dict[str, object]:
    """A JAX pipelines/derender.TrainState (its arrays as numpy) -> the
    fields of the port trainer's state (pipelines/derender.TrainState.
    from_fields, a core/checkpoint train-state step): "derenderer" (the
    state_dict, running statistics included, through
    derenderer_state_dict_from_jax), "opt_state" {"count", "mu", "nu"}
    (Adam's count and moments, the moments by parameter name through the
    same key map) and "step".  The JAX optimizer state is optax's chain
    (add_decayed_weights, scale_by_adam, scale_by_learning_rate); the
    schedule's count equals Adam's in a trainer's state."""
    sd = derenderer_state_dict_from_jax(
        {"params": state.params, "batch_stats": state.batch_stats},
        stage_sizes)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    moments = {}
    for k in ("mu", "nu"):
        full = derenderer_state_dict_from_jax(
            {"params": getattr(adam, k), "batch_stats": state.batch_stats},
            stage_sizes)
        moments[k] = {n: full[n] for n in sd
                      if not n.endswith(("running_mean", "running_var",
                                         "num_batches_tracked"))}
    return {"derenderer": sd,
            "opt_state": {"count": torch.tensor(int(np.asarray(adam.count))),
                          **moments},
            "step": torch.tensor(int(np.asarray(state.step)))}


def semantic_state_dicts_from_jax(variables: Mapping,
                                  pool_scales=(1, 2, 3, 6)
                                  ) -> Tuple[Dict[str, torch.Tensor],
                                             Dict[str, torch.Tensor]]:
    """flax {"params", "batch_stats"} of the JAX SemanticModel -> the
    reference's two state_dicts (encoder: ResnetDilated resnet50 deep
    stem; decoder: PPMBilinearDeepsup), which SemanticModel.encoder and
    .decoder load.  Inverse of JAX utils/port.py:port_semantic."""
    P, S = variables["params"], variables["batch_stats"]
    enc: Dict[str, torch.Tensor] = {}
    _resnet_trunk(enc, "", P["encoder"], S["encoder"], (3, 4, 6, 3),
                  n_convs=3, deep_stem=True)
    dp, ds = P["decoder"], S["decoder"]
    dec: Dict[str, torch.Tensor] = {}
    for k in range(len(pool_scales)):
        _conv(dec, f"ppm.{k}.1", dp[f"ppm{k}_conv"])
        _bn(dec, f"ppm.{k}.2", dp[f"ppm{k}_bn"], ds[f"ppm{k}_bn"])
    _conv(dec, "conv_last.0", dp["conv_last0"])
    _bn(dec, "conv_last.1", dp["conv_last_bn"], ds["conv_last_bn"])
    _conv(dec, "conv_last.4", dp["conv_last1"])
    _conv(dec, "cbr_deepsup.0", dp["cbr_deepsup"]["conv"])
    _bn(dec, "cbr_deepsup.1", dp["cbr_deepsup"]["bn"],
        ds["cbr_deepsup"]["bn"])
    _conv(dec, "conv_last_deepsup", dp["conv_last_deepsup"])
    return enc, dec


def _down_up_state_dict(sd: Dict[str, torch.Tensor], P: Mapping,
                        n_downsampling: int, n_blocks: int) -> None:
    """The `model.N` Sequential of the pix2pixHD G and E: conv_in at 1,
    stride-2 convs every 3 from 4, residual blocks one index each (their
    convs at conv_block.1 / .5), deconvs every 3, conv_out one past the
    last reflection pad (JAX utils/port.py port_global_generator)."""
    idx = 1
    _conv(sd, f"model.{idx}", P["conv_in"])
    idx += 3
    for i in range(n_downsampling):
        _conv(sd, f"model.{idx}", P[f"down{i}"])
        idx += 3
    for i in range(n_blocks):
        _conv(sd, f"model.{idx}.conv_block.1", P[f"res{i}"]["conv1"])
        _conv(sd, f"model.{idx}.conv_block.5", P[f"res{i}"]["conv2"])
        idx += 1
    for i in range(n_downsampling):
        _conv(sd, f"model.{idx}", P[f"up{i}"])
        idx += 3
    _conv(sd, f"model.{idx + 1}", P["conv_out"])


def global_generator_state_dict_from_jax(params: Mapping,
                                         n_downsampling: int = 4,
                                         n_blocks: int = 9
                                         ) -> Dict[str, torch.Tensor]:
    """flax GlobalGenerator params -> the reference's `model.N.*`
    state_dict (inverse of JAX utils/port.py:port_global_generator)."""
    sd: Dict[str, torch.Tensor] = {}
    _down_up_state_dict(sd, params, n_downsampling, n_blocks)
    return sd


def encoder_state_dict_from_jax(params: Mapping, n_downsampling: int = 4
                                ) -> Dict[str, torch.Tensor]:
    """flax Encoder params -> the reference's `model.N.*` state_dict
    (inverse of JAX utils/port.py:port_encoder)."""
    sd: Dict[str, torch.Tensor] = {}
    _down_up_state_dict(sd, params, n_downsampling, 0)
    return sd


# torchvision vgg16.features index of each LPIPS conv (JAX utils/port.py
# port_lpips)
_LPIPS_CONV_FEATURES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def lpips_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax LPIPS variables (models/lpips.init_lpips or port_lpips) ->
    the official `lpips` state_dict layout that the port's LPIPS loads
    (net.slice{s}.{i}.*, lin{k}.model.1.weight [1, C, 1, 1],
    scaling_layer.shift/scale).  Inverse of JAX utils/port.py:port_lpips."""
    from sdn3d_tpu_torch.models.lpips import _SCALE, _SHIFT, _SLICE_ENDS

    P = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for conv_idx, feat_idx in enumerate(_LPIPS_CONV_FEATURES):
        s = 1 + sum(feat_idx >= end for end in _SLICE_ENDS[:-1])
        _conv(sd, f"net.slice{s}.{feat_idx}", P["net"][f"conv{conv_idx}"])
    k = 0
    while f"lin{k}" in P:
        sd[f"lin{k}.model.1.weight"] = _t(
            np.asarray(P[f"lin{k}"]).reshape(1, -1, 1, 1))
        k += 1
    sd["scaling_layer.shift"] = _t(np.asarray(_SHIFT).reshape(1, 3, 1, 1))
    sd["scaling_layer.scale"] = _t(np.asarray(_SCALE).reshape(1, 3, 1, 1))
    return sd


def maskrcnn_state_dict_from_jax(variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} of the JAX MaskRCNN -> the
    reference's state_dict (maskrcnn/model.py, mask_rcnn_*.pth), which the
    port's models/maskrcnn.MaskRCNN loads: fpn.C1.0 / fpn.C1.1 (the stem's
    conv and BN), fpn.C{2..5}.{j}.conv{k} / bn{k} / downsample.{0,1},
    fpn.P{k}_conv1, fpn.P{k}_conv2.1, rpn.conv_{shared,class,bbox},
    classifier.{conv,bn}{1,2} / linear_{class,bbox}, mask.conv{1..5} /
    bn{1..4} / deconv.  The stage sizes are read off the variables.
    Inverse of JAX utils/port.py:port_maskrcnn."""
    P, S = variables["params"], variables["batch_stats"]
    R, RS = P["fpn"]["resnet"], S["fpn"]["resnet"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "fpn.C1.0", R["conv1"])
    _bn(sd, "fpn.C1.1", R["bn1"], RS["bn1"])
    for s in range(2, 6):
        j = 0
        while f"C{s}_{j}" in R:
            bp, bs, dst = R[f"C{s}_{j}"], RS[f"C{s}_{j}"], f"fpn.C{s}.{j}"
            for k in range(1, 4):
                _conv(sd, f"{dst}.conv{k}", bp[f"conv{k}"])
                _bn(sd, f"{dst}.bn{k}", bp[f"bn{k}"], bs[f"bn{k}"])
            if "downsample_conv" in bp:
                _conv(sd, f"{dst}.downsample.0", bp["downsample_conv"])
                _bn(sd, f"{dst}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])
            j += 1
    for k in range(2, 6):
        _conv(sd, f"fpn.P{k}_conv1", P["fpn"][f"P{k}_conv1"])
        _conv(sd, f"fpn.P{k}_conv2.1", P["fpn"][f"P{k}_conv2"])
    for n in ("conv_shared", "conv_class", "conv_bbox"):
        _conv(sd, f"rpn.{n}", P["rpn"][n])
    C, CS = P["classifier"], S["classifier"]
    for k in (1, 2):
        _conv(sd, f"classifier.conv{k}", C[f"conv{k}"])
        _bn(sd, f"classifier.bn{k}", C[f"bn{k}"], CS[f"bn{k}"])
    _linear(sd, "classifier.linear_class", C["linear_class"])
    _linear(sd, "classifier.linear_bbox", C["linear_bbox"])
    M, MS = P["mask"], S["mask"]
    for k in range(1, 5):
        _conv(sd, f"mask.conv{k}", M[f"conv{k}"])
        _bn(sd, f"mask.bn{k}", M[f"bn{k}"], MS[f"bn{k}"])
    _conv(sd, "mask.deconv", M["deconv"])
    _conv(sd, "mask.conv5", M["conv5"])
    return sd
