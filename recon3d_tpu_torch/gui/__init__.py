"""GUI layer: viewer + app shell (Qt optional; PyTorch port of recon3d_tpu/gui)."""
