"""tests/test_scale.py on the port, on the CPU: 150 views through the
incremental pipeline, the registration rate, the host-side wave-candidate
bookkeeping kept to a small share of the run, and the pose quality
against the true arc, at the JAX test's gates."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests.render import render_views

torch.set_num_threads(2)


@pytest.mark.slow
def test_sfm_150_views_registration_and_host_scaling():
    n = 150
    scene = render_views(n_views=n, image_size=(96, 128), arc_step=0.008)
    iset = image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"]))
    pipe = SfMPipeline(config=ReconstructionConfig.fast(), device="cpu")
    points, _, poses = pipe.reconstruct(image_set=iset)

    assert len(poses) >= int(0.9 * n), f"registered only {len(poses)}/{n}"
    assert len(points) >= 250

    waves = pipe.stats["incremental_breakdown_s"]
    total = pipe.stats["total_time"]
    assert waves["cands"] < 0.15 * total, (
        f"candidate scan {waves['cands']:.1f}s of {total:.1f}s")

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from scripts.parity_run import pose_errors_vs_gt

    class _P:
        def __init__(self, R, t):
            self.R, self.t = R, t

    center_rel, rot_deg = pose_errors_vs_gt(
        {i: _P(*pose) for i, pose in pipe.poses.items()},
        np.asarray(scene["Rs"]), np.asarray(scene["ts"]))
    assert rot_deg < 3.0 and center_rel < 0.15
