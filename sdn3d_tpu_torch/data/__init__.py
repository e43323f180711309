"""data (PyTorch port of sdn3d_tpu.data)."""
