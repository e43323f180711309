"""render (PyTorch port of sdn3d_tpu.render)."""

from sdn3d_tpu_torch.render.renderer import (
    RenderType, render, render_targets, Renderer)
