"""The dense stages on the card against the same code on the CPU, where K1
runs its plain version: the stages that reuse K1 (TSDF fusion, the plane
sweep, PatchMatch's checkpoint branch, undistortion at load), and dense
SIFT.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor the JAX package, so it also runs on a GPU machine without
them:

    python -m pytest --noconftest tests/test_torch_dense_cuda.py
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

# An installed package named `tests` would win over this directory, which
# has no __init__.py: bind the name to it, as chip_smoke.py does, unless it
# is bound already.
_HERE = str(Path(__file__).resolve().parent)
if _HERE not in [str(Path(p).resolve()) for p in getattr(sys.modules.get("tests"), "__path__", [])]:
    sys.modules["tests"] = types.ModuleType("tests")
    sys.modules["tests"].__path__ = [_HERE]

from recon3d_tpu_torch.camera import Camera  # noqa: E402
from recon3d_tpu_torch.config import (  # noqa: E402
    DenseSiftConfig,
    PatchMatchConfig,
    PlaneSweepConfig,
)
from recon3d_tpu_torch.dense import plane_sweep, sift_dense, tsdf  # noqa: E402
from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS  # noqa: E402
from recon3d_tpu_torch.runtime.checkpoint import StageCheckpointer  # noqa: E402
from recon3d_tpu_torch.kernels import warp  # noqa: E402
from tests.render import render_views  # noqa: E402
from tests.torch_scene import surface_gate  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (compares the card with the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene():
    return render_views(n_views=6, image_size=(96, 128), arc_step=0.16)


def test_fuse_tsdf_card_matches_cpu(cuda_device, scene):
    """One K1 launch a view on the card, none of the plain version; the
    volume equal to the CPU's to 1e-5 on >= 99.9% of the voxels (a voxel
    projected onto a rounding tie may snap to the other pixel)."""
    depths = scene["depth"].astype(np.float32)
    confs = np.random.default_rng(0).integers(0, 5, depths.shape).astype(np.float32)
    args = (depths, confs, scene["K"], np.stack(scene["Rs"]), np.stack(scene["ts"]))
    kw = dict(resolution=96, trunc_voxels=2.5, min_conf=2.0)
    cpu = tsdf.fuse_tsdf(*args, device="cpu", **kw)
    warp.counts.reset()
    card = tsdf.fuse_tsdf(*args, device=cuda_device, **kw)
    assert warp.counts.kernel == len(depths) and warp.counts.plain == 0
    bad = (np.abs(card.tsdf - cpu.tsdf) > 1e-5) | (np.abs(card.weight - cpu.weight) > 1e-5)
    assert bad.mean() <= 1e-3, int(bad.sum())
    assert (card.weight > 0).mean() > 0.05


@pytest.mark.parametrize("hierarchical", [True, False])
def test_sweep_card_matches_cpu(cuda_device, scene, hierarchical):
    """sweep_depth_maps of three reference views on the card: one K1 launch
    per chunk of 8 planes (and one for the full-resolution candidates), the
    depths within 2e-2 relative of the CPU's on >= 95% of the pixels both
    count as confident, equal counts on >= 99% of them (windowed NCC over
    the rendered texture is chaotic under last-bit changes of the warp)."""
    gray = scene["images"].mean(-1).astype(np.float32)
    refs, srcs = [1, 2, 3], [[0, 2, 3, 4], [1, 3, 4, 0], [2, 4, 1, 5]]
    Rs, ts = np.stack(scene["Rs"]), np.stack(scene["ts"])
    host = [gray[refs], np.stack([gray[s] for s in srcs]), np.asarray(scene["K"], np.float32),
            Rs[refs], ts[refs], np.stack([Rs[s] for s in srcs]), np.stack([ts[s] for s in srcs]),
            np.float32([2.0, 8.0])]
    kw = dict(num_depths=64, patch=5, ncc_threshold=0.7, hierarchical=hierarchical)
    d_c, c_c, _ = plane_sweep.sweep_depth_maps(*(torch.from_numpy(a) for a in host), **kw)
    warp.counts.reset()
    d_g, c_g, _ = plane_sweep.sweep_depth_maps(
        *(torch.from_numpy(a).to(cuda_device) for a in host), **kw)
    torch.cuda.synchronize()
    assert warp.counts.kernel == 8 + hierarchical and warp.counts.plain == 0
    d_c, c_c, d_g, c_g = (x.cpu().numpy() for x in (d_c, c_c, d_g, c_g))
    conf = (c_c >= 3) & (c_g >= 3)
    assert conf.mean() > 0.3
    rel = np.abs(d_g - d_c) / d_c
    assert (rel[conf] < 2e-2).mean() >= 0.95
    assert (c_g[conf] == c_c[conf]).mean() >= 0.99


def test_plane_sweep_reconstructor_on_the_card(cuda_device, scene):
    """tests/test_plane_sweep.py::test_full_reconstructor's gate on the
    card: more than 3000 points, more than 95% in front of the middle view,
    and the depth maps for the mesh stage left on the card."""
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(6)}
    cfg = PlaneSweepConfig(scale=1.0, num_depths=64, min_views=3, voxel_size=0.01)
    warp.counts.reset()
    pts, cols, maps = plane_sweep.PlaneSweepReconstructor(
        Camera.from_matrix(scene["K"]), cfg, device=cuda_device,
    ).reconstruct(scene["images"], poses, return_maps=True)
    assert warp.counts.kernel == 9 and warp.counts.plain == 0
    assert len(pts) > 3000 and cols.shape == pts.shape
    Xc = pts @ scene["Rs"][2].T + scene["ts"][2]
    assert (Xc[:, 2] > 0).mean() > 0.95
    assert maps["depth"].device.type == "cuda" and maps["conf"].device.type == "cuda"


def test_dense_sift_card_matches_cpu(cuda_device):
    """DenseSiftReconstructor on the card and on the CPU, on the scene of
    tests/test_dense_sift.py, by outcome (their RANSAC draws differ):
    point counts within 0.8-1.25 of each other, and both at that test's
    gate, median distance to the true surfaces under 0.05."""
    scene = render_views(n_views=4, image_size=(128, 160), arc_step=0.15)
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(4)}
    cfg = DenseSiftConfig(max_features=2048, min_parallax_deg=0.3)
    clouds = []
    for dev in ("cpu", cuda_device):
        rec = sift_dense.DenseSiftReconstructor(Camera.from_matrix(scene["K"]), cfg, device=dev)
        pts, cols = rec.reconstruct(scene["images"], poses)
        assert len(pts) > 200 and cols.shape == pts.shape
        assert surface_gate(pts)[0] < 0.05
        clouds.append(pts)
    assert 0.8 <= len(clouds[1]) / len(clouds[0]) <= 1.25, [len(c) for c in clouds]


def test_checkpoint_resume_on_the_card_is_bit_for_bit(cuda_device, tmp_path):
    """tests/test_torch_checkpoint.py's kill-and-resume on the card, against
    the card's own run without checkpoints: the checkpointed run, the
    resume after views 3 and 4 are lost and the fully checkpointed rerun
    give the same cloud, bit for bit, and only the resume launches K1."""
    scene = render_views(n_views=5, image_size=(96, 128), arc_step=0.12)
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(5)}
    cfg = PatchMatchConfig(scale=1.0, num_iterations=2, patch_size=7, min_views=3,
                           voxel_size=0.01)
    rec = PatchMatchMVS(Camera.from_matrix(scene["K"]), cfg, device=cuda_device)
    p_fresh, c_fresh = rec.reconstruct(scene["images"], poses)
    ck = StageCheckpointer(str(tmp_path))
    runs = [rec.reconstruct(scene["images"], poses, checkpointer=ck)]
    for i in (3, 4):
        Path(ck.depth_path(i)).unlink()
    warp.counts.reset()
    runs.append(rec.reconstruct(scene["images"], poses, checkpointer=ck))
    assert warp.counts.kernel > 0 and warp.counts.plain == 0
    warp.counts.reset()
    runs.append(rec.reconstruct(scene["images"], poses, checkpointer=ck))
    assert warp.counts.kernel == 0
    assert len(p_fresh) > 500
    for p, c in runs:
        np.testing.assert_array_equal(p, p_fresh)
        np.testing.assert_array_equal(c, c_fresh)


def test_undistortion_at_load_card_matches_cpu(cuda_device, tmp_path):
    """Distorted 480x640 inputs: load_image_set undistorts their 3 colour
    planes a view through K1's `shared` variant on the card; the images
    agree with the CPU's to one uint8 level on at most 0.5% of the values
    (tests/test_torch_io.py's bound against the JAX loader), and
    undistort_points agrees to 1e-6."""
    from PIL import Image

    from recon3d_tpu_torch.io.dataset import load_image_set
    from recon3d_tpu_torch.ops.image import distort_points, undistort_points

    scene = render_views(n_views=2, image_size=(480, 640), arc_step=0.1)
    for i, img in enumerate(scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / f"v_{i:02d}.png")
    dist = np.float32([-0.15, 0.04, 0.002, -0.001, 0.0])
    cam = Camera.from_matrix(scene["K"], dist)
    cpu = load_image_set(str(tmp_path), cam, device="cpu")
    warp.counts.reset()
    card = load_image_set(str(tmp_path), cam, device=cuda_device)
    assert warp.counts.kernel == 1 and warp.counts.plain == 0
    assert warp.counts.by_variant.get("shared", 0) == 1, dict(warp.counts.by_variant)
    diff = np.abs(card.color - cpu.color)
    assert diff.max() <= 1.0 / 255 + 1e-6
    assert (diff > 1e-6).mean() <= 0.005

    xy = torch.from_numpy(np.float32(np.random.default_rng(2).uniform(-0.4, 0.4, (4096, 2))))
    d = torch.from_numpy(dist)
    und_c = undistort_points(distort_points(xy, d), d)
    und_g = undistort_points(distort_points(xy.to(cuda_device), d.to(cuda_device)),
                             d.to(cuda_device))
    np.testing.assert_allclose(und_g.cpu().numpy(), und_c.numpy(), rtol=0, atol=1e-6)
