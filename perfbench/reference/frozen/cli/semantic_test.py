# Frozen copy of sdn3d_tpu_torch/cli/semantic_test.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""The semantic inference CLI's labelling of one frame (mirrors
semantic/vkitti_test.py:46-79), the semantic stage of the fused edit
chain; the CLI and its loaders are taken out.
"""

from __future__ import annotations

import numpy as np


def infer_image(model, image_rgb: np.ndarray, args) -> np.ndarray:
    """uint8 RGB frame -> uint8 label map.  The reference normalization
    (vkitti_dataset.py:43-44,152: BGR order, ImageNet means x255, stds in
    0..1 scale) happens on the device, in the one multi-scale pass."""
    from perfbench.reference.frozen.pipelines.semantic import multiscale_labels_fused

    device = next(model.parameters()).device
    return multiscale_labels_fused(model, np.ascontiguousarray(image_rgb),
                                   scales=tuple(args.scales), device=device)
