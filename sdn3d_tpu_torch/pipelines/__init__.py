"""pipelines (PyTorch port of sdn3d_tpu.pipelines)."""
