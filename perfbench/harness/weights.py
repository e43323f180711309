"""Random weights made on the device from the seed, in the state_dict
layout of the benchmark's frozen reference, which the port shares.

One torch.Generator on the device draws every float tensor of every net
in one call; each tensor is then scaled by its role: convolution and
linear weights He-normal (std sqrt(2 / fan_in)), norm scales 1 + 0.1 n,
biases 0.05 n, BatchNorm running means 0 and variances 1.  The
derenderer's output layer (`_fc3`) is drawn HEAD_SCALE times smaller:
its outputs (pose offsets, log scale and depth, class logits, FFD
coefficients) then start near zero, so each car is posed in its box at
the depth its box implies, as a trained model poses it; at the He scale
the random poses put the cars off screen or at infinite depth, and the
re-render draws nothing.  The same
seed gives the same tensors, so the reference can make them again after
the measured window instead of holding a second copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.harness.traffic import torch_seed

HEAD_SCALE = 1e-2
HEADS = ("derenderer._fc3.",)


def layouts(kind: str) -> Dict[str, Dict[str, Tuple[Tuple[int, ...],
                                                     torch.dtype]]]:
    """{net: {key: (shape, dtype)}} of the reference's nets for `kind`
    ("chain": semantic, derenderer, netG, netE; "derenderer": the
    derenderer alone), built on the meta device (no memory, no init)."""
    from perfbench.reference.frozen.models.derenderer import Derenderer
    nets = {}
    with torch.device("meta"):
        if kind == "chain":
            from perfbench.reference.frozen.models.semantic import \
                SemanticModel
            from perfbench.reference.frozen.pipelines.textural import (
                TexturalConfig, TexturalTrainer)
            nets["semantic"] = SemanticModel(num_class=14)
            nets["derenderer"] = Derenderer(num_classes=8)
            tex = TexturalTrainer(TexturalConfig())
            nets["netG"], nets["netE"] = tex.netG, tex.netE
        elif kind == "derenderer":
            nets["derenderer"] = Derenderer(num_classes=8)
        else:
            raise ValueError(f"no weight layout {kind!r}")
    return {name: {k: (tuple(v.shape), v.dtype)
                   for k, v in net.state_dict().items()}
            for name, net in nets.items()}


def _role(key: str, shape: Tuple[int, ...]) -> str:
    last = key.rsplit(".", 1)[-1]
    if last == "running_mean":
        return "zero"
    if last == "running_var":
        return "one"
    if len(shape) >= 2:
        return "weight"
    if last == "weight":
        return "scale"
    return "bias"


def make(layout: Dict[str, Dict[str, Tuple[Tuple[int, ...], torch.dtype]]],
         seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: state_dict} on `device` for `layout` (see `layouts`)."""
    floats: List[Tuple[str, str, Tuple[int, ...]]] = []
    for net in sorted(layout):
        for key, (shape, dtype) in layout[net].items():
            if dtype.is_floating_point:
                floats.append((net, key, shape))
    total = sum(math.prod(s) for _, _, s in floats)
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 10))
    flat = torch.randn(total, generator=g, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in layout}
    off = 0
    for net, key, shape in floats:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        role = _role(key, shape)
        if role == "zero":
            t = torch.zeros_like(t)
        elif role == "one":
            t = torch.ones_like(t)
        elif role == "weight":
            fan_in = math.prod(shape[1:])
            t = t * math.sqrt(2.0 / fan_in)
        elif role == "scale":
            t = 1.0 + 0.1 * t
        else:
            t = 0.05 * t
        if f"{net}.{key}".startswith(HEADS):
            t = t * HEAD_SCALE
        out[net][key] = t
    for net in layout:
        for key, (shape, dtype) in layout[net].items():
            if not dtype.is_floating_point:
                out[net][key] = torch.zeros(shape, dtype=dtype, device=device)
    return out
