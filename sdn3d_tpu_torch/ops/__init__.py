"""ops (PyTorch port of sdn3d_tpu.ops)."""
