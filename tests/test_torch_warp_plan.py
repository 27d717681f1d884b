"""K1's launch planner (recon3d_tpu_torch/kernels/warp.py::plan_launch).

A pure function of the shapes and the coordinate pointer's alignment, so it
is held here on the CPU at every shape the main path gives K1 and at the
edge cases; tests/test_torch_warp_cuda.py holds each variant it can pick to
the plain version on the card.
"""

import pytest

from recon3d_tpu_torch.kernels import warp

# (N, H, W, Nc, M, coordinate pointer mod 16) -> (variant, grid, vec, dynamic
# shared bytes), on an H100's limits (132 SMs, 232,448 B a block).
MAIN_PATH = [
    # PatchMatch, a batch of 4 views x 4 sources, and the last batch of 2
    ((16, 120, 160, 16, 172_800, 0), ("plane", (169, 16), 4, 0)),
    ((16, 120, 160, 16, 96_000, 0), ("plane", (94, 16), 4, 0)),
    ((16, 120, 160, 16, 19_200, 0), ("plane", (38, 16), 2, 0)),
    ((16, 30, 40, 16, 15_600, 0), ("plane", (61, 16), 1, 0)),
    ((16, 30, 40, 16, 10_800, 0), ("plane", (43, 16), 1, 0)),
    ((8, 120, 160, 8, 172_800, 0), ("plane", (169, 8), 4, 0)),
    ((8, 120, 160, 8, 96_000, 0), ("plane", (94, 8), 4, 0)),
    ((8, 120, 160, 8, 19_200, 0), ("plane", (75, 8), 1, 0)),
    ((8, 30, 40, 8, 15_600, 0), ("plane", (61, 8), 1, 0)),
    ((8, 30, 40, 8, 10_800, 0), ("plane", (43, 8), 1, 0)),
    # the TSDF lookup: depth and confidence at the points of 192^3 voxels
    ((2, 120, 160, 1, 7_077_888, 0), ("shared_smem", (132, 1), 4, 153_608)),
    # the plane sweep: its 8-plane chunks and its candidates
    ((150, 60, 80, 150, 38_400, 0), ("plane", (38, 150), 4, 0)),
    ((150, 120, 160, 150, 96_000, 0), ("plane", (94, 150), 4, 0)),
]
EDGES = [
    # three 480x640 colour planes (undistortion): too large to stage
    ((3, 480, 640, 1, 307_200, 0), ("shared", (600, 1), 2, 0)),
    # one and three shared planes: two blocks an SM, then one at 230,408 B
    ((1, 120, 160, 1, 7_077_888, 0), ("shared_smem", (264, 1), 4, 76_808)),
    ((3, 120, 160, 1, 7_077_888, 0), ("shared_smem", (132, 1), 4, 230_408)),
    # more planes than a grid's y dimension holds: the kernel loops over them
    ((70_000, 2, 3, 70_000, 4, 0), ("plane", (1, 65_535), 2, 0)),
    # M not a multiple of 4, coordinates only 8-byte aligned: narrower loads
    ((16, 120, 160, 16, 172_801, 0), ("plane", (676, 16), 1, 0)),
    ((16, 120, 160, 16, 172_802, 0), ("plane", (338, 16), 2, 0)),
    ((2, 120, 160, 1, 7_077_888, 8), ("shared_smem", (132, 1), 1, 153_608)),
]


@pytest.mark.parametrize("shape, want", MAIN_PATH + EDGES,
                         ids=lambda c: "x".join(map(str, c)) if len(c) == 6 else None)
def test_plan_at_main_path_shapes_and_edges(shape, want):
    plan = warp.plan_launch(*shape)
    assert (plan.variant, plan.grid, plan.vec, plan.smem_bytes) == want
    assert plan.smem_bytes <= warp.H100.smem_block
    assert plan.block == warp.THREADS[plan.variant]
    assert plan.variant in warp.variants_for(*shape[:4])
    assert plan.grid[1] <= warp.MAX_GRID_Y
    assert plan.block * plan.grid[0] * plan.grid[1] > 0


def test_forced_variants_and_refusals():
    """A variant or a width can be forced where it fits, and is refused
    where it does not; shapes the kernel's 32-bit indices or 8-byte loads
    cannot take are refused before any launch."""
    gathered = warp.plan_launch(2, 120, 160, 1, 7_077_888, 0, variant="shared")
    assert (gathered.grid, gathered.block, gathered.vec, gathered.smem_bytes) == (
        (6_912, 1), 256, 4, 0)
    narrow = warp.plan_launch(16, 120, 160, 16, 172_800, 0, vec=1)
    assert (narrow.variant, narrow.grid, narrow.vec) == ("plane", (675, 16), 1)
    assert warp.variants_for(4, 120, 160, 1) == ["shared"]  # 307,208 B
    assert warp.variants_for(4, 120, 160, 4) == ["plane"]
    assert warp.vec_widths(172_802, 0) == [2, 1] and warp.vec_widths(172_800, 8) == [1]
    with pytest.raises(ValueError):
        warp.plan_launch(4, 120, 160, 1, 4096, 0, variant="shared_smem")
    with pytest.raises(ValueError):
        warp.plan_launch(4, 120, 160, 4, 4096, 0, variant="shared")
    with pytest.raises(ValueError):
        warp.plan_launch(4, 120, 160, 4, 4096, 8, vec=4)  # misaligned for float4
    with pytest.raises(ValueError):
        warp.plan_launch(2, 8, 8, 2, 64, 4)           # coordinates 4-byte aligned
    with pytest.raises(ValueError):
        warp.plan_launch(1, 8, 8, 1, 2**30, 0)        # beyond 32-bit indexing
    with pytest.raises(ValueError):
        warp.plan_launch(3, 8, 8, 2, 64, 0)           # 2 coordinate rows, 3 planes


def test_plan_follows_the_device_limits():
    """A card with fewer SMs or less shared memory gets a smaller persistent
    grid or no staged variant."""
    small = warp.DeviceLimits(sms=66, smem_block=101_376, smem_sm=102_400)
    assert warp.plan_launch(2, 120, 160, 1, 7_077_888, 0, small).variant == "shared"
    one = warp.plan_launch(1, 120, 160, 1, 7_077_888, 0, small)
    assert (one.variant, one.grid) == ("shared_smem", (66, 1))
