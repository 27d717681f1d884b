"""K1's launch planner (recon3d_tpu_torch/kernels/warp.py::plan_launch).

A pure function of the shapes and the coordinate pointer's alignment, so it
is held here on the CPU at every shape the main path gives K1 and at the
edge cases; tests/test_torch_warp_cuda.py holds each variant it can pick to
the plain version on the card.
"""

import pytest

from recon3d_tpu_torch.kernels import warp

# (N, H, W, Nc, M, coordinate pointer mod 16) -> (variant, grid, vec, dynamic
# shared bytes, planes a block), on an H100's limits (132 SMs, 232,448 B a
# block).
MAIN_PATH = [
    # PatchMatch, a batch of 4 views x 4 sources, and the last batch of 2
    ((16, 120, 160, 16, 172_800, 0), ("plane", (169, 16), 4, 0, 1)),
    ((16, 120, 160, 16, 96_000, 0), ("plane", (94, 16), 4, 0, 1)),
    ((16, 120, 160, 16, 19_200, 0), ("plane", (38, 16), 2, 0, 1)),
    ((16, 30, 40, 16, 15_600, 0), ("plane", (61, 16), 1, 0, 1)),
    ((16, 30, 40, 16, 10_800, 0), ("plane", (43, 16), 1, 0, 1)),
    ((8, 120, 160, 8, 172_800, 0), ("plane", (169, 8), 4, 0, 1)),
    ((8, 120, 160, 8, 96_000, 0), ("plane", (94, 8), 4, 0, 1)),
    ((8, 120, 160, 8, 19_200, 0), ("plane", (75, 8), 1, 0, 1)),
    ((8, 30, 40, 8, 15_600, 0), ("plane", (61, 8), 1, 0, 1)),
    ((8, 30, 40, 8, 10_800, 0), ("plane", (43, 8), 1, 0, 1)),
    # the TSDF lookup: depth and confidence at the points of 192^3 voxels
    ((2, 120, 160, 1, 7_077_888, 0), ("shared_smem", (132, 1), 4, 153_608, 2)),
    # the plane sweep: its 8-plane chunks and its candidates
    ((150, 60, 80, 150, 38_400, 0), ("plane", (38, 150), 4, 0, 1)),
    ((150, 120, 160, 150, 96_000, 0), ("plane", (94, 150), 4, 0, 1)),
    # `shared`, its planes split into groups on grid y until the blocks reach
    # 528 (1,024 threads on each of 132 SMs): SuperPoint's descriptors,
    # LightGlue's training, the undistortion at load, calibration's refinement
    ((256, 60, 80, 1, 2_048, 0), ("shared", (8, 86), 1, 0, 3)),
    ((256, 16, 16, 1, 256, 0), ("shared", (1, 256), 1, 0, 1)),
    ((18, 192, 256, 1, 49_152, 0), ("shared", (192, 3), 1, 0, 6)),
    ((2, 480, 640, 1, 6_534, 0), ("shared", (26, 2), 1, 0, 1)),
]
EDGES = [
    # three 480x640 colour planes (undistortion): too large to stage
    ((3, 480, 640, 1, 307_200, 0), ("shared", (600, 1), 2, 0, 3)),
    # one and three shared planes: two blocks an SM, then one at 230,408 B
    ((1, 120, 160, 1, 7_077_888, 0), ("shared_smem", (264, 1), 4, 76_808, 1)),
    ((3, 120, 160, 1, 7_077_888, 0), ("shared_smem", (132, 1), 4, 230_408, 3)),
    # more planes than a grid's y dimension holds: the kernel loops over them
    ((70_000, 2, 3, 70_000, 4, 0), ("plane", (1, 65_535), 2, 0, 1)),
    # M not a multiple of 4, coordinates only 8-byte aligned: narrower loads
    ((16, 120, 160, 16, 172_801, 0), ("plane", (676, 16), 1, 0, 1)),
    ((16, 120, 160, 16, 172_802, 0), ("plane", (338, 16), 2, 0, 1)),
    ((2, 120, 160, 1, 7_077_888, 8), ("shared_smem", (132, 1), 1, 153_608, 2)),
]


@pytest.mark.parametrize("shape, want", MAIN_PATH + EDGES,
                         ids=lambda c: "x".join(map(str, c)) if len(c) == 6 else None)
def test_plan_at_main_path_shapes_and_edges(shape, want):
    plan = warp.plan_launch(*shape)
    assert (plan.variant, plan.grid, plan.vec, plan.smem_bytes, plan.planes_per_block) == want
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


# (N, M, planes_per_block forced) -> (grid, planes in the last group): a
# `shared` launch split by hand, with a tail group where P does not divide N
FORCED_SPLITS = [
    ((256, 2_048, 3), ((8, 86), 1)),
    ((256, 2_048, 256), ((8, 1), 256)),    # one group: PR 11's launch
    ((10, 1_000, 3), ((4, 4), 1)),
    ((10, 1_000, 4), ((4, 3), 2)),
    ((18, 49_152, 1), ((192, 18), 1)),
    ((70_000, 4, 1), ((1, 65_535), 1)),   # more groups than grid y holds: loops
]


@pytest.mark.parametrize("case, want", FORCED_SPLITS,
                         ids=lambda c: "x".join(map(str, c)) if len(c) == 3 else None)
def test_forced_split_of_shared_planes(case, want):
    N, M, P = case
    plan = warp.plan_launch(N, 20, 24, 1, M, 0, variant="shared", vec=1, planes_per_block=P)
    grid, tail = want
    assert (plan.variant, plan.grid, plan.planes_per_block) == ("shared", grid, P)
    assert N - (warp._cdiv(N, P) - 1) * P == tail


@pytest.mark.parametrize("P", [0, -1, 11])
def test_planes_per_block_beyond_1_to_n_is_refused(P):
    with pytest.raises(ValueError):
        warp.plan_launch(10, 20, 24, 1, 1_000, 0, planes_per_block=P)


def test_fixed_variants_take_only_their_own_planes_per_block():
    """`plane` takes one plane a grid row and `shared_smem` all N a block:
    forcing another split of theirs is refused, forcing their own is not."""
    assert warp.plan_launch(4, 20, 24, 4, 1_000, 0, planes_per_block=1).variant == "plane"
    assert warp.plan_launch(4, 20, 24, 1, 1_000, 0, planes_per_block=4).variant == "shared_smem"
    with pytest.raises(ValueError):
        warp.plan_launch(4, 20, 24, 4, 1_000, 0, planes_per_block=2)
    with pytest.raises(ValueError):
        warp.plan_launch(4, 20, 24, 1, 1_000, 0, planes_per_block=2)
    split = warp.plan_launch(4, 20, 24, 1, 1_000, 0, variant="shared", planes_per_block=2)
    assert (split.grid, split.planes_per_block) == ((4, 2), 2)


def test_split_follows_the_device_limits():
    """Fewer SMs want fewer blocks: SuperPoint's shape takes larger groups."""
    small = warp.DeviceLimits(sms=66, smem_block=101_376, smem_sm=102_400)
    plan = warp.plan_launch(256, 60, 80, 1, 2_048, 0, small)
    assert (plan.variant, plan.grid, plan.planes_per_block) == ("shared", (8, 37), 7)


def test_shared_refuses_planes_beyond_its_32_bit_plane_index():
    with pytest.raises(ValueError):
        warp.plan_launch(2**29, 2, 3, 1, 4, 0)
    assert warp.plan_launch(2**29 - 1, 2, 3, 1, 4, 0).variant == "shared"
