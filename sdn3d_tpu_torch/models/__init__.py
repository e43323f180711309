"""models (PyTorch port of sdn3d_tpu.models)."""
