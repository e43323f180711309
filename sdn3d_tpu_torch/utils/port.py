"""flax variables -> PyTorch state_dict for the derenderer.

The exact inverse of sdn3d_tpu/utils/port.py:port_derenderer, so weights
trained or ported on the JAX side load one to one into
models/derenderer.Derenderer:

  conv       [kh, kw, I, O] -> [O, I, kh, kw]
  dense      [I, O]         -> [O, I]
  batchnorm  scale/bias -> weight/bias; batch_stats mean/var ->
             running_mean/running_var (num_batches_tracked = 0)
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(dst: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    dst[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                            (3, 2, 0, 1)))


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


def derenderer_state_dict_from_jax(variables: Mapping,
                                   stage_sizes=(2, 2, 2, 2)
                                   ) -> Dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree (numpy arrays) of the JAX
    Derenderer -> torch state_dict with the reference key layout
    (net.conv1, net.bn1, net.layerI.J.*, net.fc, fc1, fc2, _fc3)."""
    P = variables["params"]
    S = variables["batch_stats"]
    tp, ts = P["net"]["trunk"], S["net"]["trunk"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "net.conv1", tp["conv1"])
    _bn(sd, "net.bn1", tp["bn1"], ts["bn1"])
    for i, blocks in enumerate(stage_sizes):
        for j in range(blocks):
            src = f"layer{i + 1}_{j}"
            dst = f"net.layer{i + 1}.{j}"
            bp, bs = tp[src], ts[src]
            for k in (1, 2):
                _conv(sd, f"{dst}.conv{k}", bp[f"conv{k}"])
                _bn(sd, f"{dst}.bn{k}", bp[f"bn{k}"], bs[f"bn{k}"])
            if "downsample_conv" in bp:
                _conv(sd, f"{dst}.downsample.0", bp["downsample_conv"])
                _bn(sd, f"{dst}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])
    _linear(sd, "net.fc", P["net"]["fc"])
    _linear(sd, "fc1", P["fc1"])
    _linear(sd, "fc2", P["fc2"])
    _linear(sd, "_fc3", P["fc3"])
    return sd
