"""Stage checkpointing: persist sparse-reconstruction state and per-view
depth maps between pipeline stages so a crashed run resumes instead of
restarting from zero.

PyTorch port of recon3d_tpu/runtime/checkpoint.py, copied: host numpy
only, atomic .npz writes in the same file format, so a checkpoint written
by either package loads in the other.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

SPARSE_NAME = "sparse_state.npz"
DEPTH_DIR = "depth_maps"


def _atomic_savez(path: str, **arrays):
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    # suffix must end in .npz or np.savez silently writes to "<tmp>.npz"
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class StageCheckpointer:
    """Save/restore the sparse SfM result (poses, points, colors) and the
    per-view PatchMatch depth and confidence maps.

    Usage:
        ckpt = StageCheckpointer(dir)
        ckpt.save_sparse(pipeline)                # after reconstruct()
        restored = ckpt.restore_sparse(pipeline)  # before reconstruct()
        PatchMatchMVS(...).reconstruct(..., checkpointer=ckpt)
    """

    def __init__(self, directory: str):
        self.directory = directory

    @property
    def sparse_path(self) -> str:
        return os.path.join(self.directory, SPARSE_NAME)

    def has_sparse(self) -> bool:
        return os.path.exists(self.sparse_path)

    def save_sparse(self, pipeline) -> None:
        ids = sorted(pipeline.poses.keys())
        Rs = np.stack([pipeline.poses[i][0] for i in ids]) if ids else np.zeros((0, 3, 3))
        ts = np.stack([pipeline.poses[i][1] for i in ids]) if ids else np.zeros((0, 3))
        points = np.asarray(pipeline.points3d, np.float32).reshape(-1, 3)
        colors = np.asarray(pipeline.point_colors, np.uint8).reshape(-1, 3)
        _atomic_savez(
            self.sparse_path,
            pose_ids=np.asarray(ids, np.int64),
            Rs=Rs.astype(np.float32),
            ts=ts.astype(np.float32),
            points=points.astype(np.float32),
            colors=colors,
            failed=np.asarray(sorted(pipeline.failed), np.int64),
        )

    # The MVS stage re-runs only the views whose maps are missing.

    def depth_path(self, view_id: int) -> str:
        return os.path.join(
            self.directory, DEPTH_DIR, f"depth_{int(view_id):04d}.npz"
        )

    def save_depth(self, view_id: int, depth, confidence) -> None:
        _atomic_savez(
            self.depth_path(view_id),
            depth=np.asarray(depth, np.float32),
            confidence=np.asarray(confidence, np.float32),
        )

    def load_depth(self, view_id: int):
        """(depth, confidence) for a checkpointed view, or None."""
        path = self.depth_path(view_id)
        if not os.path.exists(path):
            return None
        data = np.load(path)
        return data["depth"], data["confidence"]

    def restore_sparse(self, pipeline) -> bool:
        """Load a saved sparse state into the pipeline. Returns False if no
        checkpoint exists."""
        if not self.has_sparse():
            return False
        data = np.load(self.sparse_path)
        ids = data["pose_ids"].tolist()
        pipeline.poses = {
            int(i): (data["Rs"][k], data["ts"][k]) for k, i in enumerate(ids)
        }
        pipeline.registered = set(int(i) for i in ids)
        pipeline.failed = set(int(i) for i in data["failed"].tolist())
        pipeline.points3d = data["points"]
        pipeline.point_colors = data["colors"]
        return True
