"""core (PyTorch port of sdn3d_tpu.core)."""
