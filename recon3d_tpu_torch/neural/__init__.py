"""The neural front end: SuperPoint + LightGlue (PyTorch port of
recon3d_tpu/neural, its inference path)."""

from recon3d_tpu_torch.neural.matcher import NeuralMatcher
from recon3d_tpu_torch.neural.superpoint import neural_to_sift_features

__all__ = ["NeuralMatcher", "neural_to_sift_features"]
