"""Classical feature front end (PyTorch port of recon3d_tpu/features)."""

from recon3d_tpu_torch.features.frontend import FeatureExtractor, FeatureMatcher

__all__ = ["FeatureExtractor", "FeatureMatcher"]
