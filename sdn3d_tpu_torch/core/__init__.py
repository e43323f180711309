"""core (PyTorch port of sdn3d_tpu.core)."""

from sdn3d_tpu_torch.core.config import (
    DerenderConfig,
    RasterizerConfig,
    RenderConfig,
)
