"""Host runtime: device selection, native fast paths, checkpointing,
profiling, the serve daemon and the process worker (PyTorch port of
recon3d_tpu/runtime)."""

from recon3d_tpu_torch.runtime.checkpoint import StageCheckpointer
from recon3d_tpu_torch.runtime.profiling import StageTimer, maybe_trace
from recon3d_tpu_torch.runtime.worker import ReconstructionWorker

__all__ = ["StageCheckpointer", "StageTimer", "maybe_trace", "ReconstructionWorker"]
