"""utils (PyTorch port of sdn3d_tpu.utils)."""
