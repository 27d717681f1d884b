"""The planted faults that the correctness check must catch, and the
program in TF32, as context managers around a run of the program.

The port computes in float32 with TF32 off (runtime/device.disable_tf32,
called by every entry point and by each PatchMatch batch). `tf32()` lets
its matrix products and convolutions run in TF32; that changes none of
its results (PERF.md): its products have an inner size of 3. The control
is the reference's own answer in bfloat16 (each job's `control`). The
faults break the timed path underneath the harness: a step that returns
its state unchanged, half of a batch left out, an answer altered where it
is produced.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch


def _enable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


@contextlib.contextmanager
def _patched(targets: List[Tuple[object, str, Callable]]) -> Iterator[None]:
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    try:
        for obj, name, make in targets:
            setattr(obj, name, make(getattr(obj, name)))
        yield
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)


@contextlib.contextmanager
def tf32() -> Iterator[None]:
    """The program's float32 products in TF32: every module of the port that
    holds `disable_tf32` gets one that turns TF32 on."""
    import recon3d_tpu_torch  # noqa: F401

    mods = [m for n, m in list(sys.modules.items())
            if n.split(".")[0] == "recon3d_tpu_torch" and hasattr(m, "disable_tf32")]
    with _patched([(m, "disable_tf32", lambda _: _enable_tf32) for m in mods]):
        _enable_tf32()
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


def _mvs_module():
    from recon3d_tpu_torch.dense import patchmatch
    return patchmatch


@contextlib.contextmanager
def mvs_state_unchanged() -> Iterator[None]:
    """Every PatchMatch level returns its starting depth: no round runs."""
    pm = _mvs_module()
    with _patched([(pm, "_run_level",
                    lambda orig: lambda *a, **k: orig(*a, **dict(k, iters=0)))]):
        yield


@contextlib.contextmanager
def mvs_half_batch() -> Iterator[None]:
    """Each batch of views computes only its first half; the rest get no
    map (depth 0, confidence 0)."""
    pm = _mvs_module()

    def make(orig):
        def half(ref, src, K, R_refs, t_refs, R_srcss, t_srcss, ranges, generators=None, **kw):
            B = ref.shape[0]
            h = max(B // 2, 1)
            out = orig(ref[:h], src[:h], K, R_refs[:h], t_refs[:h], R_srcss[:h], t_srcss[:h],
                       ranges[:h], generators=None if generators is None else generators[:h],
                       **kw)
            pad = [torch.cat([x, torch.zeros((B - h,) + x.shape[1:], dtype=x.dtype,
                                             device=x.device)]) for x in out]
            return pm.DepthNormalMap(*pad)
        return half

    with _patched([(pm, "patchmatch_depth_batch", make)]):
        yield


@contextlib.contextmanager
def mvs_altered_depth(factor: float = 1.02) -> Iterator[None]:
    """Every depth map leaves PatchMatch scaled by `factor`."""
    pm = _mvs_module()

    def make(orig):
        def scaled(*a, **k):
            out = orig(*a, **k)
            return out._replace(depth=out.depth * factor)
        return scaled

    with _patched([(pm, "patchmatch_depth_batch", make)]):
        yield


@contextlib.contextmanager
def mvs_altered_cloud(shift: float = 1e-3) -> Iterator[None]:
    """Every fused point leaves the compaction moved by `shift` along x."""
    pm = _mvs_module()

    def make(orig):
        def moved(*a, **k):
            pts, idx = orig(*a, **k)
            return pts + np.float32([shift, 0.0, 0.0]), idx
        return moved

    with _patched([(pm, "fused_points_compact", make)]):
        yield


@contextlib.contextmanager
def sfm_state_unchanged() -> Iterator[None]:
    """Every bundle adjustment returns the cameras and points it was given."""
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    with _patched([(SfMPipeline, "bundle_adjustment_full", lambda _: lambda self, final=False: None),
                   (SfMPipeline, "bundle_adjustment_light",
                    lambda _: lambda self, iterations=2: None)]):
        yield


@contextlib.contextmanager
def sfm_half_batch() -> Iterator[None]:
    """The pipeline is handed the first half of the images only."""
    from recon3d_tpu_torch.io.dataset import ImageSet
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    def make(orig):
        def half(self, image_dir=None, max_images=None, image_set=None):
            n = len(image_set.names) // 2
            part = ImageSet(gray=image_set.gray[:n], color=image_set.color[:n],
                            camera=image_set.camera, names=image_set.names[:n],
                            sizes=image_set.sizes[:n])
            return orig(self, image_dir, max_images, part)
        return half

    with _patched([(SfMPipeline, "reconstruct", make)]):
        yield


@contextlib.contextmanager
def sfm_altered_poses(angle: float = 0.05) -> Iterator[None]:
    """Every camera leaves the pipeline rotated by `angle` rad about its z."""
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    c, s = np.cos(angle), np.sin(angle)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)

    def make(orig):
        def turned(self, *a, **k):
            out = orig(self, *a, **k)
            self.poses = {i: (Rz @ R, Rz @ t) for i, (R, t) in self.poses.items()}
            return out
        return turned

    with _patched([(SfMPipeline, "reconstruct", make)]):
        yield


CONTROLS = {"tf32": tf32}
FAULTS = {
    "mvs": {"state_unchanged": mvs_state_unchanged, "half_batch": mvs_half_batch,
            "altered_depth": mvs_altered_depth, "altered_cloud": mvs_altered_cloud},
    "sfm": {"state_unchanged": sfm_state_unchanged, "half_batch": sfm_half_batch,
            "altered_poses": sfm_altered_poses},
}
