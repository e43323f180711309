# Frozen copy of sdn3d_tpu_torch/data/semantic_data.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Semantic-branch constants (semantic/vkitti_dataset.py:43-44 and
:213-221, the eval sizes and the reference's normalisation), the part of
sdn3d_tpu/data/semantic_data.py that inference uses; the training sample
preparation is taken out.
"""

from __future__ import annotations

# the eval long-edge cap (vkitti_eval.py:175); it does not bind on the
# 375x1242 VKITTI frames
IMG_MAX_SIZE_EVAL = 1242
# img_transform normalization (semantic/vkitti_dataset.py:43-44): the
# image is flipped to BGR (:152) and then normalized with ImageNet means
# scaled to 0..255 but stds left in 0..1 scale — a reference quirk kept
# verbatim (the mean list stays in RGB order while the image is BGR).
MEAN_BGR = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD_BGR = (0.229, 0.224, 0.225)


def round2nearest_multiple(x: int, p: int) -> int:
    return ((x - 1) // p + 1) * p
