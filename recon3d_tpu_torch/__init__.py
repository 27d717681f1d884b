"""recon3d_tpu_torch: the PyTorch/CUDA port of recon3d_tpu.

A second package beside the JAX one, with the same layout and module
names. It imports torch and never jax or recon3d_tpu. Its hand-written
CUDA kernels live in csrc/ and are bound in kernels/. Entry points run on
"cuda" unless the caller passes device="cpu".

Ported so far: dense reconstruction from known poses, `python -m
recon3d_tpu_torch.cli IMAGES --mvs --from-colmap MODEL_DIR`, and the SfM
front end, `sfm.pipeline.SfMPipeline` up to `match_image_pairs` (CLAHE +
SIFT extraction, batched pair matching, F-RANSAC, the match graph).
"""

__version__ = "0.1.0"
