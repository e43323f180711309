"""Random Mask R-CNN weights made on the device from a seed, in the
detector's state_dict layout (perfbench/reference/maskrcnn_ref.layout,
which the program's MaskRCNN shares).

They are drawn as the program's models/maskrcnn.init_weights draws them
(flax's defaults): every convolution and linear kernel from a normal
truncated at two standard deviations with variance 1 / fan_in, biases 0,
BatchNorm scale 1, shift 0, running mean 0 and variance 1; here from one
torch.Generator on the device seeded from the seed given (the
configuration's: perfbench/reference/detect_ref.weights).  Then they are
"tamed" as tests/test_torch_detect.py tames them: the RPN's and the
classifier's class and box kernels HEAD_SCALE times smaller, and the
classifier's class bias set to the configuration's.  Untamed,
activations in the hundreds saturate the softmaxes to ties at 1.0 and
exp() of the box deltas makes boxes of no width or of infinite size;
tamed, the RPN's scores spread, the boxes keep their anchors' sizes, and
the class bias sets how many proposals clear the detector's confidence
of 0.7.  Last, the stem's bias cancels the molded frame's padding
(`cancel_padding`).  The same seed gives the same tensors, so the
reference makes them again after the measured window."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from perfbench.harness.traffic import torch_seed

HEAD_SCALE = 1e-3
HEADS = ("rpn.conv_class.weight", "rpn.conv_bbox.weight",
         "classifier.linear_class.weight", "classifier.linear_bbox.weight")
CLASS_BIAS = "classifier.linear_class.bias"
STEM = "fpn.C1.0"


def make(layout: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], seed: int,
         device, class_bias: Sequence[float],
         mean_pixel: Sequence[float]) -> Dict[str, torch.Tensor]:
    """The tamed state_dict on `device` for `layout` and `seed`, its
    padding cancelled for `mean_pixel`."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 30))
    sd = {}
    for key, (shape, dtype) in layout.items():
        last = key.rsplit(".", 1)[-1]
        if not dtype.is_floating_point:
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif len(shape) >= 2:
            t = torch.empty(shape, device=device)
            std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                        generator=g)
        elif last in ("weight", "running_var"):
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        sd[key] = t
    return cancel_padding(tame(sd, class_bias), mean_pixel)


def tame(sd: Dict[str, torch.Tensor], class_bias: Sequence[float]
         ) -> Dict[str, torch.Tensor]:
    """`sd` with the heads' kernels HEAD_SCALE times smaller and the
    class bias `class_bias` (a new dict; the tensors it leaves alone are
    shared)."""
    out = dict(sd)
    for key in HEADS:
        out[key] = sd[key] * HEAD_SCALE
    out[CLASS_BIAS] = torch.tensor(class_bias, dtype=sd[CLASS_BIAS].dtype,
                                   device=sd[CLASS_BIAS].device)
    return out


def cancel_padding(sd: Dict[str, torch.Tensor], mean_pixel: Sequence[float]
                   ) -> Dict[str, torch.Tensor]:
    """`sd` with the stem convolution's bias set so that the molded
    frame's padding (zero pixels, -mean_pixel once the mean is taken
    off) gives it an output of zero (up to rounding), as the image's
    outside gives the convolutions' own zero padding; every other layer
    has no bias, so the padding reads as zero features throughout.  (A
    new dict; the tensors it leaves alone are shared.)"""
    out = dict(sd)
    w = sd[STEM + ".weight"]
    out[STEM + ".bias"] = (w.sum((2, 3)) * torch.tensor(
        mean_pixel, dtype=w.dtype, device=w.device)).sum(1)
    return out
