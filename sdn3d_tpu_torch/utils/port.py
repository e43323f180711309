"""flax variables -> PyTorch state_dicts (the reference's key layouts).

The exact inverses of sdn3d_tpu/utils/port.py's port_derenderer,
port_semantic, port_global_generator, port_encoder,
port_multiscale_discriminator, port_vgg19, port_lpips and port_maskrcnn
(and the same layout rules for the global encoder, which the reference
never builds), so weights trained or ported on the JAX side load one to
one into the port's models, and a derenderer, textural or semantic train state
(weights, running statistics, Adam's moments and count or SGD's momentum
traces and schedule count; a Mask R-CNN train state's labels and momentum
traces by group) carries across to the port's trainer:

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


# a state_dict's BatchNorm statistics, which have no optimizer state
_STATS = ("running_mean", "running_var", "num_batches_tracked")


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
        moments[k] = {n: full[n] for n in sd if not n.endswith(_STATS)}
    return {"derenderer": sd,
            "opt_state": {"count": torch.tensor(int(np.asarray(adam.count))),
                          **moments},
            "step": torch.tensor(int(np.asarray(state.step)))}


def semantic_decoder_state_dict_from_jax(
        dp: Mapping, ds: Mapping, arch_decoder: str = "ppm_bilinear_deepsup",
        pool_scales=(1, 2, 3, 6)) -> Dict[str, torch.Tensor]:
    """A semantic decoder's flax params / batch_stats -> the state_dict of
    the port's `arch_decoder` under the reference's keys
    (ModelBuilder.build_decoder's decoders, semantic/models.py)."""
    dec: Dict[str, torch.Tensor] = {}

    def cbr(name):
        _conv(dec, f"{name}.0", dp[name]["conv"])
        _bn(dec, f"{name}.1", dp[name]["bn"], ds[name]["bn"])

    if arch_decoder.startswith("ppm"):
        for k in range(len(pool_scales)):
            _conv(dec, f"ppm.{k}.1", dp[f"ppm{k}_conv"])
            _bn(dec, f"ppm.{k}.2", dp[f"ppm{k}_bn"], ds[f"ppm{k}_bn"])
        _conv(dec, "conv_last.0", dp["conv_last0"])
        _bn(dec, "conv_last.1", dp["conv_last_bn"], ds["conv_last_bn"])
        _conv(dec, "conv_last.4", dp["conv_last1"])
    else:
        cbr("cbr")
        _conv(dec, "conv_last", dp["conv_last"])
    if arch_decoder.endswith("deepsup"):
        cbr("cbr_deepsup")
        _conv(dec, "conv_last_deepsup", dp["conv_last_deepsup"])
    return dec


def semantic_state_dicts_from_jax(variables: Mapping,
                                  pool_scales=(1, 2, 3, 6),
                                  arch_decoder: str = "ppm_bilinear_deepsup"
                                  ) -> Tuple[Dict[str, torch.Tensor],
                                             Dict[str, torch.Tensor]]:
    """flax {"params", "batch_stats"} of the JAX SemanticModel -> the
    reference's two state_dicts (encoder: ResnetDilated resnet50 deep
    stem; decoder: `arch_decoder`, PPMBilinearDeepsup by default), which
    SemanticModel.encoder and .decoder load.  The default is the inverse
    of JAX utils/port.py:port_semantic; the other decoders keep the
    reference's keys (`ppm.K.{1,2}`, `conv_last.{0,1,4}`; `cbr.{0,1}`,
    `conv_last`; `cbr_deepsup.{0,1}`, `conv_last_deepsup`)."""
    P, S = variables["params"], variables["batch_stats"]
    enc: Dict[str, torch.Tensor] = {}
    _resnet_trunk(enc, "", P["encoder"], S["encoder"], (3, 4, 6, 3),
                  n_convs=3, deep_stem=True)
    dec = semantic_decoder_state_dict_from_jax(P["decoder"], S["decoder"],
                                               arch_decoder, pool_scales)
    return enc, dec


def _opt_leaf(state, attr: str):
    """The first optax state (a NamedTuple) in a nested chain state that
    has the field `attr`."""
    if attr in getattr(state, "_fields", ()):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _opt_leaf(s, attr)
            if found is not None:
                return found
    return None


def semantic_train_state_from_jax(state, arch_decoder: str =
                                  "ppm_bilinear_deepsup",
                                  pool_scales=(1, 2, 3, 6)
                                  ) -> Dict[str, object]:
    """A JAX pipelines/semantic.SemanticTrainState (its arrays as numpy)
    -> the fields of the port trainer's state (pipelines/semantic.
    SemanticTrainState.from_fields, a core/checkpoint train-state step):
    "encoder" and "decoder" (the state_dicts, running statistics
    included), "opt_enc" and "opt_dec" ({"count", "trace"}: the schedule's
    count and the momentum traces by parameter name, through the same key
    maps) and "step".  Each JAX optimizer state is optax's chain
    (add_decayed_weights, (trace, scale_by_schedule))."""
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    enc, dec = semantic_state_dicts_from_jax(variables, pool_scales,
                                             arch_decoder)
    fields: Dict[str, object] = {"encoder": enc, "decoder": dec}
    for key, opt, part in (("opt_enc", state.opt_state_enc, "encoder"),
                           ("opt_dec", state.opt_state_dec, "decoder")):
        trace = _opt_leaf(opt, "trace").trace
        P = dict(state.params)
        P[part] = trace
        t_enc, t_dec = semantic_state_dicts_from_jax(
            {"params": P, "batch_stats": state.batch_stats}, pool_scales,
            arch_decoder)
        full = t_enc if part == "encoder" else t_dec
        fields[key] = {
            "count": torch.tensor(int(np.asarray(
                _opt_leaf(opt, "count").count))),
            "trace": {n: v for n, v in full.items()
                      if not n.endswith(_STATS)}}
    fields["step"] = torch.tensor(int(np.asarray(state.step)))
    return fields


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


def discriminator_state_dict_from_jax(params: Mapping
                                      ) -> Dict[str, torch.Tensor]:
    """flax MultiscaleDiscriminator params ({"scale{i}": {"conv{j}"}}) ->
    the reference's getIntermFeat keys `scale{i}_layer{j}.0.*`
    (networks.py:375-380; inverse of JAX utils/port.py:
    port_multiscale_discriminator).  The scale and layer counts are read
    off the params."""
    sd: Dict[str, torch.Tensor] = {}
    for scale, P in params.items():
        j = 0
        while f"conv{j}" in P:
            _conv(sd, f"{scale}_layer{j}.0", P[f"conv{j}"])
            j += 1
    return sd


# torchvision vgg19.features index of each conv (JAX utils/port.py
# port_vgg19)
_VGG19_CONV_FEATURES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30,
                        32, 34)


def vgg19_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax Vgg19Features variables ({"params": {"conv{k}"}}) ->
    torchvision's `features.N.*` keys, which models/vgg.Vgg19Features
    loads (inverse of JAX utils/port.py:port_vgg19)."""
    P = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for k, idx in enumerate(_VGG19_CONV_FEATURES):
        if f"conv{k}" not in P:
            break
        _conv(sd, f"features.{idx}", P[f"conv{k}"])
    return sd


def global_encoder_state_dict_from_jax(params: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """flax GlobalEncoder params -> the port's GlobalEncoder state_dict
    (the same names: conv_in, block{i}_conv1 / _conv2 / _skip, fc_mu,
    fc_logvar).  The block count is read off the params."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_in", params["conv_in"])
    i = 0
    while f"block{i}_conv1" in params:
        for part in ("conv1", "conv2", "skip"):
            if f"block{i}_{part}" in params:
                _conv(sd, f"block{i}_{part}", params[f"block{i}_{part}"])
        i += 1
    _linear(sd, "fc_mu", params["fc_mu"])
    _linear(sd, "fc_logvar", params["fc_logvar"])
    return sd


def _count(params: Mapping, prefix: str) -> int:
    return sum(1 for k in params if k.startswith(prefix))


def textural_train_state_from_jax(state) -> Dict[str, object]:
    """A JAX pipelines/textural.TexturalState -> the fields of the port
    trainer's state (pipelines/textural.TexturalState.load_fields, a
    core/checkpoint train-state step): "netG", "netE", "netD", "vgg" and,
    with the global encoder, "netGlobalE" state_dicts; "opt_g" and
    "opt_d" ({"count", "mu", "nu"}, Adam's count and moments by the port's
    parameter names, "netG.*" / "netE.*" / "netGlobalE.*" for the G
    optimizer, which netGlobalE rides); "step".  The net sizes are read
    off the params."""
    def g_side(t):
        out = {"netG": global_generator_state_dict_from_jax(
            t["g"], _count(t["g"], "down"), _count(t["g"], "res")),
            "netE": encoder_state_dict_from_jax(t["e"], _count(t["e"],
                                                               "down"))}
        if t["ge"]:
            out["netGlobalE"] = global_encoder_state_dict_from_jax(t["ge"])
        return out

    nets = g_side({"g": state.params_g, "e": state.params_e,
                   "ge": state.params_ge})
    fields: Dict[str, object] = dict(nets)
    fields["netD"] = discriminator_state_dict_from_jax(state.params_d)
    fields["vgg"] = vgg19_state_dict_from_jax(state.vgg)
    for key, opt, convert in (
            ("opt_g", state.opt_g, lambda m: {
                f"{net}.{n}": v for net, sd in g_side(m).items()
                for n, v in sd.items()}),
            ("opt_d", state.opt_d, discriminator_state_dict_from_jax)):
        adam = next(s for s in opt if hasattr(s, "mu"))
        fields[key] = {"count": torch.tensor(int(adam.count)),
                       "mu": convert(adam.mu), "nu": convert(adam.nu)}
    fields["step"] = torch.tensor(int(state.step))
    return fields


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


def _masked_tree(tree, params: Mapping):
    """A params-shaped (values, indicator) pair of numpy trees from an optax
    tree masked by multi_transform: a leaf of the group keeps its array
    (indicator 1), a leaf of another group (optax's MaskedNode, which has
    no shape) becomes zeros (indicator 0)."""
    if isinstance(params, Mapping):
        pairs = {k: _masked_tree(tree.get(k) if isinstance(tree, Mapping)
                                 else None, p) for k, p in params.items()}
        return ({k: v for k, (v, _) in pairs.items()},
                {k: i for k, (_, i) in pairs.items()})
    shape = np.shape(params)
    if getattr(tree, "shape", None) == shape:
        return np.asarray(tree), np.ones(shape, np.float32)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


def maskrcnn_train_state_from_jax(state: Mapping) -> Dict[str, object]:
    """A JAX pipelines/detect_train state ({"params", "batch_stats",
    "opt_state", "step"}, its arrays as numpy) -> the fields of the port
    trainer's state (pipelines/detect_train.DetectTrainState.from_fields,
    a core/checkpoint train-state step): "maskrcnn" (the state_dict,
    running statistics included, through maskrcnn_state_dict_from_jax),
    "opt_state" {"labels": {name: label}, "trace": {group: {name:
    tensor}}} and "step".  The optimizer state is optax.multi_transform's
    over the labels "train", "transfer" and "freeze", each moved group a
    chain (clip_by_global_norm, add_decayed_weights, (trace,
    scale_by_learning_rate)) masked to its parameters: a parameter's label
    is the group whose trace holds it, "freeze" where none does."""
    P, S = state["params"], state["batch_stats"]
    sd = maskrcnn_state_dict_from_jax({"params": P, "batch_stats": S})
    names = [n for n in sd if not n.endswith(_STATS)]
    labels = {n: "freeze" for n in names}
    trace: Dict[str, Dict[str, torch.Tensor]] = {}
    for group, inner in state["opt_state"].inner_states.items():
        leaf = _opt_leaf(inner, "trace")
        if leaf is None:
            continue
        values, held = _masked_tree(leaf.trace, P)
        v_sd = maskrcnn_state_dict_from_jax({"params": values,
                                             "batch_stats": S})
        h_sd = maskrcnn_state_dict_from_jax({"params": held,
                                             "batch_stats": S})
        mine = [n for n in names if bool(h_sd[n].all())]
        for n in mine:
            labels[n] = group
        trace[group] = {n: v_sd[n] for n in mine}
    return {"maskrcnn": sd,
            "opt_state": {"labels": labels, "trace": trace},
            "step": torch.tensor(int(np.asarray(state["step"])))}


def sparse_adam_state_from_jax(state):
    """The JAX package's sparse Adam state (core/optimizers.py: its
    SparseAdamState, or the optax chain state of `sparse_adam` that holds
    it) -> port core/optimizers.SparseAdamState: the count, and the moments
    as nested dicts of float32 tensors of the params' keys."""
    from sdn3d_tpu_torch.core.optimizers import SparseAdamState

    s = _opt_leaf(state, "nu")
    if s is None or "count" not in s._fields:
        raise ValueError("no sparse Adam state (count, mu, nu) in the "
                         "given optimizer state")

    def tree(x):
        if isinstance(x, Mapping):
            return {k: tree(v) for k, v in x.items()}
        return _t(x)

    return SparseAdamState(count=int(np.asarray(s.count)), mu=tree(s.mu),
                           nu=tree(s.nu))
