"""ops (PyTorch port of sdn3d_tpu.ops).  The rasterize functions dispatch
on their input's device: the CUDA kernels (ops/rasterize_cuda.py, built
at first use) on a card, their plain versions on the CPU."""

from sdn3d_tpu_torch.ops.rasterize import (
    rasterize_face_maps,
    rasterize_silhouettes,
    rasterize_depth,
    rasterize_face_colors,
)
