# Frozen copy of sdn3d_tpu_torch/pipelines/semantic.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Semantic branch pipeline: training, multi-scale inference, metrics.

PyTorch counterpart of sdn3d_tpu/pipelines/semantic.py (semantic/
vkitti_{train,eval,test}.py):
  - SemanticTrainer: two SGD optimizers with momentum, one for the encoder
    and one for the decoder (vkitti_train.py:93-117), each optax's
    chain(add_decayed_weights(1e-4), sgd(poly schedule, momentum 0.9)),
    written as a plain function over the parameter lists (`sgd_step`);
    the loss is the NLL plus 0.4 times the deep-supervision head's
    (vkitti_train.py:225-226);
  - multi-scale averaged-softmax inference (vkitti_eval.py:50-107): one
    device pass per frame over the raw uint8 RGB frame (BGR flip, mean/std
    normalisation with true division, the float32 operations JAX's
    callers apply on the host before multiscale_inference /
    multiscale_labels; a resize to each scale's size rounded up to x8,
    the model, the sum of the softmaxes, the division by the scale count,
    a uint8 argmax) and one uint8 fetch;
  - mIoU and pixel accuracy (semantic/utils.py:146-173), host numpy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.frozen.data.semantic_data import (
    IMG_MAX_SIZE_EVAL, MEAN_BGR, STD_BGR, round2nearest_multiple)
from perfbench.reference.frozen.models.semantic import (
    SemanticModel, resize_bilinear)
from perfbench.reference.frozen.utils.transfer import constant, to_device

EVAL_SCALES = (100, 150, 200, 300, 375)   # short-edge sizes


def scale_sizes(height: int, width: int,
                scales: Sequence[int] = EVAL_SCALES) -> List[Tuple[int, int]]:
    """Per-scale (h, w) of the reference eval protocol
    (vkitti_dataset.py:213-221): short edge to the scale, long-edge cap,
    both dims rounded UP to a multiple of 8 (the image is resized to
    them, not padded)."""
    sizes = []
    for s in scales:
        scale = min(s / min(height, width), IMG_MAX_SIZE_EVAL / max(height, width))
        sizes.append((round2nearest_multiple(int(height * scale), 8),
                      round2nearest_multiple(int(width * scale), 8)))
    return sizes


@torch.no_grad()
def _scales_mean(model: SemanticModel, x: torch.Tensor,
                 scales: Sequence[int]) -> torch.Tensor:
    """The mean over the scales of the softmax [C, H, W] of x [1, 3, H, W]
    resized to each scale's size (JAX multiscale_probs_device)."""
    H, W = x.shape[2], x.shape[3]
    total = None
    sizes = scale_sizes(H, W, scales)
    for hw in sizes:
        p = model(resize_bilinear(x, hw), seg_size=(H, W))[0]
        total = p if total is None else total + p
    return total / len(sizes)


def multiscale_probs_device(model: SemanticModel, image_rgb_u8: np.ndarray,
                            scales: Sequence[int] = EVAL_SCALES,
                            device="cuda") -> torch.Tensor:
    """Averaged multi-scale softmax [C, H, W] on the device, from the raw
    uint8 RGB frame [H, W, 3]: one upload of the frame, normalised on the
    device with the JAX program's float32 operations."""
    dev = torch.device(device)
    img = to_device(np.asarray(image_rgb_u8, np.uint8), dev)
    mean = constant(tuple(MEAN_BGR), torch.float32, dev)
    std = constant(tuple(STD_BGR), torch.float32, dev)
    with torch.no_grad():
        x = img.to(torch.float32).flip(-1)                  # BGR
        x = torch.div(x - mean, std)                        # true division
        return _scales_mean(model, x.permute(2, 0, 1)[None], scales)


def multiscale_labels_device(model: SemanticModel, image_rgb_u8: np.ndarray,
                             scales: Sequence[int] = EVAL_SCALES,
                             device="cuda") -> torch.Tensor:
    """Argmax labels [H, W] uint8 as a device tensor (one pass)."""
    probs = multiscale_probs_device(model, image_rgb_u8, scales, device)
    return torch.argmax(probs, dim=0).to(torch.uint8)


def multiscale_labels_fused(model: SemanticModel, image_rgb_u8: np.ndarray,
                            scales: Sequence[int] = EVAL_SCALES,
                            device="cuda") -> np.ndarray:
    """Argmax labels [H, W] uint8 from the raw uint8 RGB frame: one device
    pass and one 1-byte/pixel fetch."""
    return multiscale_labels_device(model, image_rgb_u8, scales,
                                    device).cpu().numpy()
