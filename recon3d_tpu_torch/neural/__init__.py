"""The neural front end: SuperPoint + LightGlue (PyTorch port of
recon3d_tpu/neural): inference (superpoint, lightglue, matcher), weights in
both directions (weights), the synthetic corpus (synthetic), the losses
and train steps (train) and the pretraining loops (pretrain, run as
`python -m recon3d_tpu_torch.neural.pretrain`, so not imported here)."""

from recon3d_tpu_torch.neural.matcher import NeuralMatcher
from recon3d_tpu_torch.neural.superpoint import neural_to_sift_features
from recon3d_tpu_torch.neural.train import (
    Adam,
    TrainState,
    create_train_state,
    make_epoch_train_fn,
    make_lightglue_train_fn,
    make_pair_train_step,
    warmup_cosine_decay_schedule,
)
from recon3d_tpu_torch.neural.weights import (
    flax_init_,
    load_lightglue_torch,
    load_superpoint_torch,
    save_params_npz,
)

HAS_NEURAL = True

__all__ = [
    "NeuralMatcher", "neural_to_sift_features", "HAS_NEURAL",
    "Adam", "TrainState", "create_train_state", "make_epoch_train_fn",
    "make_lightglue_train_fn", "make_pair_train_step", "warmup_cosine_decay_schedule",
    "flax_init_", "load_lightglue_torch", "load_superpoint_torch", "save_params_npz",
]
