"""sdn3d_tpu_torch: the PyTorch / CUDA (Hopper) port of sdn3d_tpu.

Mirrors the JAX package's layout (geometry/, ops/, render/, models/,
pipelines/, data/, utils/, cli/) so each module's counterpart is easy to
find.  Plain tensor code is PyTorch; each TPU kernel of the JAX package
is a hand-written CUDA kernel (csrc/: the forward rasterizer, and the
silhouette gradient's edge walk and pixel->face reduction), bound in
ops/rasterize_cuda.py.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
Nothing falls back to the CPU when no GPU is found.
"""

__version__ = "0.1.0"
