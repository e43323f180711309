"""geometry (PyTorch port of sdn3d_tpu.geometry)."""
