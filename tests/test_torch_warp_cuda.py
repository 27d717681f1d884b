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
    assert warp.counts.by_shape == {warp.shape_key(planes, xy): 1}
    assert valid.shape == vref.shape == out.shape
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


def _case(rng, device, N, H, W, Nc, M, misaligned=False, planes_offset=False):
    """Planes in [0, 1] and M points a coordinate row over a margin of two
    pixels around the image, led by NaN, +-inf, the exact far corner and
    the origin. misaligned: the coordinates start 8 bytes past a 16-byte
    boundary. planes_offset: the planes start one odd-sized plane into
    their allocation, so they cannot be copied with TMA."""
    planes = torch.from_numpy(rng.random((N + planes_offset, H, W)).astype(np.float32))
    planes = planes.to(device)[int(planes_offset):]
    xy = np.stack([rng.random((Nc, M)) * (W + 3) - 2, rng.random((Nc, M)) * (H + 3) - 2], -1)
    special = [(np.nan, 0.5), (0.5, np.inf), (-np.inf, 0.0), (W - 1, H - 1), (0.0, 0.0)]
    xy[0, :min(M, len(special))] = special[:M]
    flat = torch.zeros(Nc * M * 2 + 2 * misaligned, device=device)
    coords = flat[2 * misaligned:].view(Nc, M, 2)
    coords.copy_(torch.from_numpy(xy.astype(np.float32)))
    assert coords.data_ptr() % 16 == (8 if misaligned else 0)
    return planes, coords


# (variant, N, H, W, Nc, M, coordinates misaligned, planes not TMA-aligned
# [, planes a block forced: `shared`'s groups on grid y])
VARIANT_CASES = [
    ("plane", 16, 30, 40, 16, 3600, False, False),
    ("shared", 2, 120, 160, 1, 40000, False, False),
    ("shared_smem", 2, 120, 160, 1, 40000, False, False),
    ("shared_smem", 3, 31, 33, 1, 40000, False, True),   # plain-load staging
    ("shared_smem", 3, 120, 160, 1, 4096, False, False),  # 230,408 B of shared memory
    ("shared", 4, 120, 160, 1, 4096, False, False),       # planes do not fit
    ("plane", 3, 20, 24, 3, 1003, False, False),          # tail: M % 4 = 3, vec 1
    ("shared", 3, 20, 24, 1, 1001, False, False),
    ("shared_smem", 3, 20, 24, 1, 1001, False, False),
    ("plane", 3, 20, 24, 3, 1002, False, False),          # M % 4 = 2: vec 2 or 1
    ("shared_smem", 3, 20, 24, 1, 1002, False, False),
    ("plane", 3, 20, 24, 3, 1000, True, False),           # misaligned coordinates
    ("shared", 3, 20, 24, 1, 1000, True, False),
    ("shared_smem", 3, 20, 24, 1, 1000, True, False),
    ("plane", 3, 1, 57, 3, 400, False, False),            # H = 1, W = 1
    ("plane", 3, 57, 1, 3, 400, False, False),
    ("shared", 2, 1, 57, 1, 400, False, False),
    ("shared_smem", 2, 57, 1, 1, 400, False, False),
    ("plane", 70_000, 2, 3, 70_000, 4, False, False),     # planes beyond grid y
    # `shared` split over grid y: the planner's groups at SuperPoint's and
    # LightGlue training's shapes (3 and 1 planes at vec 1), 3 planes a
    # group with a tail group of 1, one group of all N (more than a batch
    # of U planes), misaligned coordinates under a split, and more groups
    # than grid y holds
    ("shared", 256, 60, 80, 1, 2048, False, False),
    ("shared", 256, 16, 16, 1, 256, False, False),
    ("shared", 10, 20, 24, 1, 1000, False, False, 3),
    ("shared", 10, 20, 24, 1, 1000, False, False, 10),
    ("shared", 10, 20, 24, 1, 1000, True, False, 3),
    ("shared", 70_000, 2, 3, 1, 4, False, False, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", VARIANT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_every_variant_is_bit_identical_to_plain(rng, case, cuda_device):
    """Each variant the planner can pick, forced, at every vector width the
    layout allows, against the plain version: the same bits in samples and
    validity, tails, misaligned coordinates, planes that TMA cannot copy or
    that do not fit, one-pixel-wide planes, more planes than a grid's y
    dimension holds, and `shared`'s planes split into groups."""
    variant, N, H, W, Nc, M, misaligned, planes_offset, *forced = case
    P = forced[0] if forced else None
    planes, coords = _case(rng, cuda_device, N, H, W, Nc, M, misaligned, planes_offset)
    align = coords.data_ptr() % 16
    assert variant in warp.variants_for(N, H, W, Nc, warp.device_limits(cuda_device))
    ref, vref = warp.tent_warp_reference(planes, coords, fill=-1.0)
    widths = warp.vec_widths(M, align)
    assert widths == ([1] if misaligned or M % 2 else [4, 2, 1] if M % 4 == 0 else [2, 1])
    for vec in widths:
        warp.counts.reset()
        out, valid = warp.tent_warp(planes, coords, fill=-1.0, variant=variant, vec=vec,
                                    planes_per_block=P)
        torch.cuda.synchronize()
        assert warp.counts.by_variant == {variant: 1} and warp.counts.plain == 0
        assert torch.equal(valid, vref), vec
        assert torch.equal(out, ref), vec


@pytest.mark.cuda
def test_planner_refuses_and_card_refusals_raise(rng, cuda_device):
    """A variant that cannot take the shape is refused before launch; a
    launch the card refuses (more shared memory than a block may hold)
    comes back as an error code, never as a silent no-op."""
    planes, coords = _case(rng, cuda_device, 4, 120, 160, 1, 64)
    with pytest.raises(ValueError):
        warp.tent_warp(planes, coords, variant="shared_smem")  # 307 KB of planes
    with pytest.raises(ValueError):
        warp.tent_warp(planes, coords, variant="plane")        # points are shared
    out = torch.empty((4, 64), device=cuda_device)
    valid = torch.empty((1, 64), dtype=torch.bool, device=cuda_device)
    lib = warp._library()
    rc = lib.tent_warp_launch(
        warp.VARIANTS.index("shared_smem"), 4, planes.data_ptr(), coords.data_ptr(),
        out.data_ptr(), valid.data_ptr(), 4, 64, 120, 160, 0.0, 1, 1, 1024, 307_208, 4,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    for P in (0, 5):  # `shared` takes 1 to N planes a group
        rc = lib.tent_warp_launch(
            warp.VARIANTS.index("shared"), 4, planes.data_ptr(), coords.data_ptr(),
            out.data_ptr(), valid.data_ptr(), 4, 64, 120, 160, 0.0, 1, 1, 256, 0, P,
            torch.cuda.current_stream().cuda_stream)
        assert rc != 0, P
    with pytest.raises(ValueError):
        warp.tent_warp(planes, coords, planes_per_block=5)
    limits = warp.device_limits(cuda_device)
    assert limits.sms > 0 and 0 < limits.smem_block <= limits.smem_sm


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    planes = torch.rand((2, 8, 9), device=cuda_device)
    with pytest.raises(ValueError):
        warp.tent_warp(planes, torch.zeros((2, 5, 2)))            # CPU coords
    with pytest.raises(ValueError):
        warp.tent_warp(planes.transpose(1, 2), torch.zeros((2, 5, 2), device=cuda_device))
    with pytest.raises(TypeError):
        warp.tent_warp(planes.half(), torch.zeros((2, 5, 2), device=cuda_device))
