"""Subpackage of the PyTorch port (see recon3d_tpu_torch/__init__.py)."""
