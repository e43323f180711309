"""render (PyTorch port of sdn3d_tpu.render)."""
