"""External-tool integrations (PyTorch port of recon3d_tpu/tools)."""
