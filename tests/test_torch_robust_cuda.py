"""The distorted capture of tests/test_robustness.py on the card: the same
scene and gates as tests/test_torch_robustness.py's undistort-at-load
case (tests/torch_robust_check.py), with the load's undistortion through
K1, the only end-to-end user of that call site. Every test here is marked
`cuda` and skips without a GPU. The file imports neither jax nor the JAX
package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_robust_cuda.py
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
from recon3d_tpu_torch.io.dataset import load_image_set  # noqa: E402
from recon3d_tpu_torch.kernels import warp  # noqa: E402
from tests.torch_render import render_views  # noqa: E402
from tests.torch_robust_check import (  # noqa: E402
    DIST,
    SCENE,
    check_gate,
    distorted_capture,
    undistort_shape_key,
    write_pngs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_distorted_capture_on_the_card(cuda_device, tmp_path):
    """The capture end to end on the card at the JAX gates, its load
    undistorting every colour plane in one K1 launch at the undistortion
    shape, and the plain version never."""
    out = distorted_capture(tmp_path, cuda_device)
    assert not check_gate(out), (check_gate(out), out)
    load = out["k1_by_stage"]["load"]
    assert load["plain"] == 0, load
    assert load["kernel_by_shape"] == {undistort_shape_key(): 1}, load
    assert load["kernel_by_variant"] == {"shared": 1}, load


def test_undistorted_load_matches_the_cpu(cuda_device, tmp_path):
    """The load's undistortion on the card against the same load on the
    CPU (K1's plain version): the same uint8 pixels. K1 is bit-identical to
    its plain version, so only the distortion model's coordinates, computed
    by each device's own arithmetic, may move a pixel by one level."""
    scene = render_views(**SCENE, dist=DIST)
    img_dir = write_pngs(scene["images"], tmp_path / "distorted")
    cam = Camera.from_matrix(scene["K"], DIST)
    card = load_image_set(str(img_dir), cam, device=cuda_device).color
    cpu = load_image_set(str(img_dir), cam, device="cpu").color
    diff = np.abs(card - cpu) * 255
    assert diff.max() <= 1.0 + 1e-3, diff.max()
    assert (diff > 0.5).mean() < 1e-3, (diff > 0.5).mean()


def test_k1_at_the_undistortion_shape_is_bit_identical(cuda_device):
    """K1 at the load's shape and points (18 colour planes of 192x256 at the
    49,152 forward-distorted pixel positions) against its plain version."""
    from recon3d_tpu_torch.ops.image import distort_points

    V, (H, W) = SCENE["n_views"], SCENE["image_size"]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    planes = torch.rand((3 * V, H, W), generator=gen, device=cuda_device)
    f = 0.9 * W
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=cuda_device),
                            torch.arange(W, dtype=torch.float32, device=cuda_device),
                            indexing="ij")
    d = distort_points(torch.stack([(xs - W / 2) / f, (ys - H / 2) / f], dim=-1),
                       torch.from_numpy(DIST).to(cuda_device))
    coords = (d * f + torch.tensor([W / 2, H / 2], device=cuda_device)).reshape(1, -1, 2)
    warp.counts.reset()
    out, valid = warp.tent_warp(planes, coords.contiguous())
    ref, ref_valid = warp.tent_warp_reference(planes, coords.contiguous())
    torch.cuda.synchronize()
    assert warp.shape_key(planes, coords) == undistort_shape_key()
    assert warp.counts.kernel == 1 and warp.counts.plain == 0
    assert torch.equal(valid, ref_valid) and torch.equal(out, ref)
    assert 0 < int((~valid).sum()) < valid.numel()
