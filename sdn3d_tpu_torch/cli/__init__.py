"""cli (PyTorch port of sdn3d_tpu.cli)."""
