"""Typed configuration for the whole framework (PyTorch port of
sdn3d_tpu/core/config.py, the same dataclasses and defaults).

The reference mixes three flag systems (absl flags in
geometric/scripts/main.py:31-60, argparse in semantic/vkitti_train.py and
textural/options/*, an uppercase-attribute Config class in
maskrcnn/config.py).  Here a single dataclass tree covers all branches.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Differentiable rasterizer settings.

    Defaults mirror geometric/neural_renderer/rasterize.py:7-12.
    """

    image_size: int = 256
    anti_aliasing: bool = True
    near: float = 0.1
    far: float = 100.0
    eps: float = 1e-4
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Bounded walk length for the NMR-style approximate silhouette gradient.
    # The reference CUDA kernel (rasterize.py:514-745) walks each boundary
    # pixel to the image border; contributions decay as 1/dist, so a bounded
    # window is accurate.  <= 0 means walk the whole image (exact reference
    # semantics).
    grad_walk: int = 0
    # The JAX package's forward choice ("pallas" | "xla" | "auto"), kept
    # so that a configuration reads the same in both packages; the port
    # dispatches on the tensor's device (ops/rasterize_cuda.py).
    impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Camera + render-target settings (derender3d/models/renderer.py:216-272)."""

    image_size: int = 384          # geometric/scripts/main.py:44 render_size
    viewing_angle: float = 30.0    # degrees; overridden per-focal at run time
    rasterizer: RasterizerConfig = dataclasses.field(default_factory=RasterizerConfig)


@dataclasses.dataclass(frozen=True)
class DerenderConfig:
    """Derender3d model settings (geometric/scripts/main.py:31-60)."""

    num_classes: int = 8           # 8 ShapeNet car meshes
    grid_size: int = 4             # FFD control grid
    hidden_size: int = 256
    image_size: int = 256          # input crop size
    render_size: int = 384
    max_objects: int = 16          # cap, geometric/scripts/main.py:812-818
    mask_weight: float = 0.1
    ffd_coeff_reg: float = 1.0
    lr: float = 1e-3
    lr_decay_epochs: int = 16
    lr_decay_rate: float = 0.5
    weight_decay: float = 1e-3
    batch_size: int = 64
