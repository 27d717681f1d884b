"""Scene helpers shared by the port's tests, chip_smoke.py and
tests/torch_reference_levels.py. Numpy only: no jax, no torch, so that the
GPU machine, which has no jax, can import it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from tests.render import default_scene_planes


def sparse_from_depth(scene, per_view: int, seed: int = 0,
                      views: Optional[Sequence[int]] = None) -> np.ndarray:
    """World points back-projected from `per_view` random ground-truth depth
    samples of each view (tests/test_patchmatch.py:144-156), standing in for
    SfM's sparse cloud. views: default every view of the scene."""
    rng = np.random.default_rng(seed)
    K = scene["K"]
    pts = []
    for v in range(len(scene["Rs"])) if views is None else views:
        H, W = scene["depth"][v].shape
        ii, jj = rng.integers(0, H, per_view), rng.integers(0, W, per_view)
        d = scene["depth"][v][ii, jj]
        ok = d > 0
        rays = np.stack([(jj[ok] - K[0, 2]) / K[0, 0], (ii[ok] - K[1, 2]) / K[1, 1],
                         np.ones(ok.sum())], -1)
        pts.append((rays * d[ok][:, None] - scene["ts"][v]) @ scene["Rs"][v])
    return np.concatenate(pts).astype(np.float32)


def surface_gate(points: np.ndarray) -> Tuple[float, float]:
    """Median distance of the points to the nearest true scene plane, and
    the share within 0.15: the measures of
    tests/test_patchmatch.py::test_full_mvs_reconstructor."""
    dists = np.full(len(points), np.inf)
    for p in default_scene_planes():
        d_plane = np.abs((points - p.origin) @ p.normal)
        lu = (points - p.origin) @ p.u
        lv = (points - p.origin) @ p.v
        on = (np.abs(lu) <= p.half_u + 0.1) & (np.abs(lv) <= p.half_v + 0.1)
        dists = np.where(on, np.minimum(dists, d_plane), dists)
    return float(np.median(dists)), float((dists < 0.15).mean())
