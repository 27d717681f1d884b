"""K1 on the card against its plain PyTorch version.

CUDA kernels have no CPU mode, so every test here is marked `cuda` and
skips without a GPU. The file imports neither jax nor the JAX package, so
it also runs on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_warp_cuda.py

(--noconftest: tests/conftest.py sets up jax for the rest of the suite.)
"""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.kernels import warp
from recon3d_tpu_torch.ops.image import undistort_image

# Inputs in [0, 1]; the kernel rounds every product and sum on its own, as
# the plain version does, and 2e-6 leaves room for a contracted FMA.
TOL = 2e-6


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is a CUDA kernel with no CPU mode)")
    return torch.device("cuda")


def _edge_case_inputs(rng):
    """NaN, inf, the exact far corner (W-1, H-1) and points outside the
    image (the inputs of tests/test_image_ops.py:153-170)."""
    img = rng.random((37, 53)).astype(np.float32)
    coords = (rng.random((5, 64, 2)) * np.array([60.0, 45.0]) - 4.0).astype(np.float32)
    coords[0, 0] = (np.nan, 3.0)
    coords[0, 1] = (np.inf, 3.0)
    coords[0, 2] = (52.0, 36.0)
    coords[0, 3] = (-np.inf, 1.0)
    coords[0, 4] = (2.0, np.nan)
    return img, coords


def _large_inputs(rng):
    """4,096 points inside a 48x64 image (tests/test_image_ops.py:172-185)."""
    img = rng.random((48, 64)).astype(np.float32)
    coords = (rng.random((4096, 2)) * np.array([63.0, 47.0])).astype(np.float32)
    return img, coords


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("make", [_edge_case_inputs, _large_inputs])
def test_kernel_matches_plain_on_card(rng, make, shared, cuda_device):
    """Own coordinates per plane, or one set shared by every plane."""
    img, coords = make(rng)
    planes = torch.from_numpy(np.stack([img, 1.0 - img])).to(cuda_device)
    xy = torch.from_numpy(coords.reshape(1, -1, 2)).to(cuda_device)
    if not shared:
        xy = xy.expand(2, -1, -1).contiguous()
    warp.counts.reset()
    out, valid = warp.tent_warp(planes, xy, fill=-1.0)
    ref, vref = warp.tent_warp_reference(planes, xy, fill=-1.0)
    torch.cuda.synchronize()
    assert (warp.counts.kernel, warp.counts.plain) == (1, 0)
    assert torch.equal(valid, vref)
    assert (out - ref).abs().max().item() <= TOL


@pytest.mark.cuda
def test_colour_undistort_on_card_matches_cpu(rng, cuda_device):
    """A batch of colour images undistorted on the card: all channel planes
    in one K1 launch, the same values as the plain version on the CPU."""
    img = torch.from_numpy(rng.random((3, 40, 56, 3)).astype(np.float32))
    K = torch.tensor([[50.0, 0.0, 27.5], [0.0, 52.0, 19.5], [0.0, 0.0, 1.0]])
    dist = torch.tensor([-0.2, 0.05, 0.001, -0.002, 0.0])
    warp.counts.reset()
    on_card = undistort_image(img.to(cuda_device), K, dist)
    torch.cuda.synchronize()
    assert (warp.counts.kernel, warp.counts.plain) == (1, 0)
    on_cpu = undistort_image(img, K, dist)
    # the coordinates come from the same elementwise float32 operations on
    # both devices; 1e-5 allows a last-bit difference in them (|grad| <= 1)
    assert on_card.shape == on_cpu.shape == img.shape
    assert (on_card.cpu() - on_cpu).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    planes = torch.rand((2, 8, 9), device=cuda_device)
    with pytest.raises(ValueError):
        warp.tent_warp(planes, torch.zeros((2, 5, 2)))            # CPU coords
    with pytest.raises(ValueError):
        warp.tent_warp(planes.transpose(1, 2), torch.zeros((2, 5, 2), device=cuda_device))
    with pytest.raises(TypeError):
        warp.tent_warp(planes.half(), torch.zeros((2, 5, 2), device=cuda_device))
