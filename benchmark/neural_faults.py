"""Planted faults of the learned front end, for the readings of the neural
SfM cell: each breaks the timed path's networks where they compute, and
the cell's network numbers must catch it. Importing this module adds them,
with the SfM faults of benchmark/controls.py, under the job `sfm_neural`.

    python benchmark/neural_faults.py --workload dtu49_superpoint_lightglue.sfm \
        --seeds 1 2 --variants clean bf16 tf32 lightglue_matches_dropped [--out FILE]

takes the arguments of benchmark/readings.py and runs it with these
faults known.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path
from typing import Iterator

import torch

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def lightglue_layer_skipped() -> Iterator[None]:
    """LightGlue runs its first L - 1 layers and skips the last."""
    from recon3d_tpu_torch.neural.lightglue import LightGlueNet

    orig = LightGlueNet.scores

    def fewer(self, *a, **k):
        self.num_layers -= 1
        try:
            return orig(self, *a, **k)
        finally:
            self.num_layers += 1

    LightGlueNet.scores = fewer
    try:
        yield
    finally:
        LightGlueNet.scores = orig


@contextlib.contextmanager
def superpoint_descriptors_shifted(cells: float = 0.25) -> Iterator[None]:
    """SuperPoint's descriptors are sampled `cells` of a cell (2 pixels)
    to the right of each keypoint."""
    from recon3d_tpu_torch.neural import superpoint

    orig = superpoint.bilinear_sample_auto

    def shifted(img, coords, fill=0.0):
        return orig(img, coords + coords.new_tensor([cells, 0.0]), fill)

    superpoint.bilinear_sample_auto = shifted
    try:
        yield
    finally:
        superpoint.bilinear_sample_auto = orig


@contextlib.contextmanager
def superpoint_scores_scaled(factor: float = 1.01) -> Iterator[None]:
    """SuperPoint's keypoint scores leave the detector scaled by `factor`."""
    from recon3d_tpu_torch.neural import matcher

    orig = matcher.detect_keypoints

    def scaled(*a, **k):
        f = orig(*a, **k)
        f.score = f.score * factor
        return f

    matcher.detect_keypoints = scaled
    try:
        yield
    finally:
        matcher.detect_keypoints = orig


@contextlib.contextmanager
def _matches_altered(alter) -> Iterator[None]:
    """LightGlue's matches leave extract_matches as `alter` makes them,
    before the mutual-NN fallback chooses."""
    from recon3d_tpu_torch.neural import matcher

    orig = matcher.extract_matches

    def altered(log_assign, valid0, valid1, threshold=0.1):
        return alter(orig, log_assign, valid0, valid1, threshold)

    matcher.extract_matches = altered
    try:
        yield
    finally:
        matcher.extract_matches = orig


def lightglue_matches_dropped() -> contextlib.AbstractContextManager:
    """Every second match of LightGlue's (by row) is dropped."""
    def drop(orig, log_assign, valid0, valid1, threshold):
        m = orig(log_assign, valid0, valid1, threshold)
        rows = torch.arange(m.idx2.shape[-1], device=m.idx2.device)
        keep = m.mask & (rows % 2 == 0)
        return type(m)(idx2=torch.where(keep, m.idx2, -1), score=m.score, mask=keep)

    return _matches_altered(drop)


def lightglue_threshold_raised(factor: float = 10.0) -> contextlib.AbstractContextManager:
    """LightGlue's matches are taken at `factor` times the configured
    assignment threshold."""
    return _matches_altered(lambda orig, la, v0, v1, t: orig(la, v0, v1, t * factor))


def register() -> None:
    from benchmark import controls

    controls.FAULTS["sfm_neural"] = dict(
        controls.FAULTS["sfm"], lightglue_layer_skipped=lightglue_layer_skipped,
        superpoint_descriptors_shifted=superpoint_descriptors_shifted,
        superpoint_scores_scaled=superpoint_scores_scaled,
        lightglue_matches_dropped=lightglue_matches_dropped,
        lightglue_threshold_raised=lightglue_threshold_raised)


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    register()
    from benchmark import readings

    sys.exit(readings.main())
else:
    register()
