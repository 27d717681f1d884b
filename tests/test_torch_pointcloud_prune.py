"""K2's and K3's glue on the CPU (kernels/pointcloud.py), and a model of
K2's walk (csrc/pointcloud.cu) against K2's plain version.

K2 evaluates only the candidate chunks whose box may hold a squared
distance below the block's largest last slot. The tests hold what that
rests on: the sort inside each cell keeps every cell one run, every chunk
box holds its points, and the skip's bound (box_lower_bound) never exceeds
a squared distance between the two boxes' points, rounded as the plain
version rounds it. The model walks the cube in the kernel's order with the
kernel's skip rule and is held bit for bit to the plain version; the card
holds the kernel itself to it (tests/test_torch_pointcloud_cuda.py). For
K3: the glue's query order, and a model of the warp walk's shell, clipped
to the grid.
"""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.kernels import pointcloud
from tests.torch_clouds import adversarial_clouds

torch.set_num_threads(2)


CLOUDS = adversarial_clouds()


def _d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(len(a), len(b)) squared distances rounded as the plain version rounds them."""
    dx = a[:, 0:1] - b[None, :, 0]
    dy = a[:, 1:2] - b[None, :, 1]
    dz = a[:, 2:3] - b[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


@pytest.mark.parametrize("case", sorted(CLOUDS))
def test_knn_order_keeps_every_cell_one_run(case):
    """The sort inside each cell is a permutation, and each cell's run holds
    the same points at the same start and count as the grid's cell order."""
    pts = torch.from_numpy(CLOUDS[case])
    grid = pointcloud.cell_grid(pts, 20)
    order = pointcloud.knn_order(pts, grid)
    assert torch.equal(torch.sort(order).values, torch.arange(len(pts)))
    cell = torch.repeat_interleave(torch.arange(len(grid.key)), grid.count)
    for o in (grid.order, order):
        key = torch.empty(len(pts), dtype=torch.int64)
        key[o] = cell
        assert torch.equal(key[o], cell)   # the runs are the cells, in key order
    a = torch.empty(len(pts), dtype=torch.int64)
    b = torch.empty(len(pts), dtype=torch.int64)
    a[grid.order] = cell
    b[order] = cell
    assert torch.equal(a, b)   # every point in the same cell's run


def _ring_by_ring(grid: pointcloud.CellGrid, k: int):
    """R and the cube's count walked one ring at a time, as the native
    search walks them."""
    ring = torch.full_like(grid.count, pointcloud.RING_MAX)
    cube = grid.count.clone()
    found = torch.zeros(len(grid.key), dtype=torch.bool)
    todo = torch.arange(len(grid.key))
    for r in range(1, pointcloud.RING_MAX + 1):
        if len(todo) == 0:
            break
        pos = grid.lookup(grid.key[todo, None] + grid.offsets(r, shell=True))
        cube[todo] += torch.where(pos >= 0, grid.count[pos.clamp(min=0)], 0).sum(1)
        extra = found[todo]
        ring[todo[extra]] = r
        found[todo[cube[todo] - 1 >= k]] = True
        todo = todo[~extra]
    return ring, cube


@pytest.mark.parametrize("case", sorted(CLOUDS))
@pytest.mark.parametrize("k", [8, 20, 40])
def test_ring_groups_equal_ring_by_ring(case, k):
    """cell_grid counts the rings in RING_GROUPS, with one host round trip
    a group: the same R and cube for every cell as a ring-by-ring walk."""
    grid = pointcloud.cell_grid(torch.from_numpy(CLOUDS[case]), k)
    ring, cube = _ring_by_ring(grid, k)
    assert torch.equal(grid.ring, ring) and torch.equal(grid.cube, cube)


@pytest.mark.parametrize("case", sorted(CLOUDS))
def test_chunks_split_cells_and_boxes_hold_their_points(case):
    pts = torch.from_numpy(CLOUDS[case])
    prep = pointcloud.knn_prepare(pts, 20)
    grid, cs = prep.grid, prep.chunk_start.long()
    sizes = cs.diff()
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= pointcloud.KNN_CHUNK
    assert int(cs[0]) == 0 and int(cs[-1]) == len(pts)
    cc = prep.cell_chunk.long()
    assert torch.equal(cs[cc[:-1]], grid.start)   # a cell's first chunk starts its run
    assert torch.equal(prep.chunk_cell.long(),
                       torch.repeat_interleave(torch.arange(len(grid.key)), cc.diff()))
    # chunks of one cell differ by at most one point
    per = torch.zeros(len(grid.key), dtype=torch.int64)
    per_min = torch.full((len(grid.key),), 1 << 30, dtype=torch.int64)
    per.scatter_reduce_(0, prep.chunk_cell.long(), sizes, "amax")
    per_min.scatter_reduce_(0, prep.chunk_cell.long(), sizes, "amin")
    assert int((per - per_min).max()) <= 1
    sorted_pts = prep.pts4[:, :3]
    assert torch.equal(sorted_pts, pts[prep.order])
    chunk_of = torch.repeat_interleave(torch.arange(len(sizes)), sizes)
    for box, group in ((prep.chunk_box, chunk_of),
                       (prep.cell_box, torch.repeat_interleave(torch.arange(len(grid.key)),
                                                               grid.count))):
        assert (box[group, 0, :3] <= sorted_pts).all() and (sorted_pts <= box[group, 1, :3]).all()
        # tight: each face touches a point
        lo = torch.full_like(box[:, 0, :3], torch.inf).scatter_reduce(
            0, group[:, None].expand(-1, 3), sorted_pts, "amin")
        assert torch.equal(lo, box[:, 0, :3])
    # blocks: every chunk once, heaviest cube first
    assert torch.equal(torch.sort(prep.block_chunk.long()).values, torch.arange(len(sizes)))
    w = grid.cube[prep.chunk_cell.long()[prep.block_chunk.long()]]
    assert (w.diff() <= 0).all()


def _cube_cells(grid: pointcloud.CellGrid, c: int) -> torch.Tensor:
    """The occupied cells of cell c's R-cube."""
    nb = grid.lookup(grid.key[c] + grid.offsets(int(grid.ring[c]), shell=False))
    return nb[nb >= 0]


@pytest.mark.parametrize("case", sorted(CLOUDS))
def test_skip_bound_is_conservative(case):
    """box_lower_bound between a block's chunk and every chunk (and cell) of
    its cube never exceeds the smallest squared distance between their
    points, rounded as the plain version rounds it; it is 0 for the chunk
    itself."""
    pts = torch.from_numpy(CLOUDS[case])
    prep = pointcloud.knn_prepare(pts, 20)
    grid, cs, cc = prep.grid, prep.chunk_start.long(), prep.cell_chunk.long()
    sp, box, cbox = prep.pts4[:, :3], prep.chunk_box[:, :, :3], prep.cell_box[:, :, :3]
    rng = np.random.default_rng(0)
    blocks = rng.choice(len(cs) - 1, size=min(12, len(cs) - 1), replace=False)
    checked = 0
    for b in blocks.tolist():
        c = int(prep.chunk_cell[b])
        q = sp[cs[b]:cs[b + 1]]
        assert float(pointcloud.box_lower_bound(box[b, 0], box[b, 1], box[b, 0], box[b, 1])) == 0
        for f in _cube_cells(grid, c).tolist():
            lb_cell = pointcloud.box_lower_bound(box[b, 0], box[b, 1], cbox[f, 0], cbox[f, 1])
            for x in range(int(cc[f]), int(cc[f + 1])):
                lb = pointcloud.box_lower_bound(box[b, 0], box[b, 1], box[x, 0], box[x, 1])
                d_min = _d2(q, sp[cs[x]:cs[x + 1]]).min()
                assert lb <= d_min, (b, x, float(lb), float(d_min))
                assert lb_cell <= lb    # a cell's box holds its chunks' boxes
                checked += 1
    assert checked > 0


def _shell_order(r: int) -> np.ndarray:
    """(cells, 3) offsets of shell r in the kernel's order (csrc:
    shell_offset): the x faces whole, then the y faces, then the z faces."""
    a, b = 2 * r + 1, 2 * r - 1
    out = []
    for dx in (-r, r):
        out += [(dx, dy, dz) for dy in range(-r, r + 1) for dz in range(-r, r + 1)]
    for dy in (-r, r):
        out += [(dx, dy, dz) for dx in range(-(r - 1), r) for dz in range(-r, r + 1)]
    for dz in (-r, r):
        out += [(dx, dy, dz) for dx in range(-(r - 1), r) for dy in range(-(r - 1), r)]
    assert len(out) == a ** 3 - b ** 3
    return np.array(out)


def walk_model(points: torch.Tensor, k: int, max_blocks: int = 48):
    """K2's walk on the CPU for the heaviest block and up to max_blocks - 1
    others (seeded): each block's chunk against its own chunk, the rest of
    its cell, then the cells of shells 1..R in the kernel's order, a chunk
    taken only where box_lower_bound < T (the block's largest (k + 1)-th
    smallest so far); the lists as the k + 1 smallest. Returns (the blocks'
    points' indices, their values, the pairs evaluated, the ring rule's
    pairs of those blocks)."""
    prep = pointcloud.knn_prepare(points, k)
    grid, cs, cc = prep.grid, prep.chunk_start.long(), prep.cell_chunk.long()
    sp, box = prep.pts4[:, :3], prep.chunk_box[:, :, :3]
    order_all = prep.block_chunk.tolist()
    rng = np.random.default_rng(1)
    rest = rng.permutation(len(order_all) - 1)[:max_blocks - 1] + 1
    rows, values, pairs, ring_pairs = [], [], 0, 0
    for b in [order_all[0]] + [order_all[i] for i in sorted(rest.tolist())]:
        c = int(prep.chunk_cell[b])
        walk = [b] + [x for x in range(int(cc[c]), int(cc[c + 1])) if x != b]
        for r in range(1, int(grid.ring[c]) + 1):
            o = torch.from_numpy(_shell_order(r))
            f = grid.lookup(grid.key[c] + o[:, 0] * grid.steps[0] + o[:, 1] * grid.steps[1]
                            + o[:, 2])
            for cell in f[f >= 0].tolist():
                walk += range(int(cc[cell]), int(cc[cell + 1]))
        q = sp[cs[b]:cs[b + 1]]
        best = torch.full((len(q), k + 1), torch.inf)
        T, evaluated = torch.tensor(torch.inf), 0
        for x in walk:
            if not pointcloud.box_lower_bound(box[b, 0], box[b, 1], box[x, 0], box[x, 1]) < T:
                continue
            cand = sp[cs[x]:cs[x + 1]]
            best = torch.topk(torch.cat([best, _d2(q, cand)], 1), k + 1, dim=1,
                              largest=False, sorted=True).values
            T = best[:, k].max()
            evaluated += len(cand)
        pairs += len(q) * (evaluated - 1)
        ring_pairs += len(q) * (int(grid.cube[c]) - 1)
        kk = min(k, int(grid.cube[c]) - 1)
        s = torch.zeros(len(q), dtype=torch.float32)
        for j in range(1, kk + 1):   # best[:, 0] is a 0: the point's own
            s = s + torch.sqrt(best[:, j])
        values.append(s / torch.full_like(s, float(kk)) if kk > 0 else s)
        rows.append(prep.order[cs[b]:cs[b + 1]])
    return torch.cat(rows), torch.cat(values), pairs, ring_pairs


@pytest.mark.parametrize("case", sorted(CLOUDS))
@pytest.mark.parametrize("k", [8, 20, 40])
def test_walk_model_equals_plain(case, k):
    """The skip rule is exact: the walk's values are the plain version's bit
    for bit, and it evaluates at most the ring rule's pairs (fewer on the
    surface, where most chunks lie far beyond a point's k-th neighbour)."""
    pts = torch.from_numpy(CLOUDS[case])
    rows, got, pairs, ring_pairs = walk_model(pts, k)
    assert torch.equal(got, pointcloud.knn_mean_dist_reference(pts, k, rows=rows))
    assert pairs <= ring_pairs
    if case == "surface":
        assert pairs * 2 < ring_pairs, (pairs, ring_pairs)


@pytest.mark.parametrize("case", ["inside", "beyond"])
def test_nearest_query_sort_round_trips(case):
    """K3's glue orders the queries by the linear key of their cell (clamped
    to one cell beyond the grid) and leaves them in the callers' order:
    query_id is a permutation, the keys rise along it, consecutive queries
    share cells, and results written at query_id come back in the callers'
    order. The reference points' w carries their original index's bits."""
    rng = np.random.default_rng(17)
    ref = rng.normal(size=(3000, 3)).astype(np.float32)
    query = rng.normal(size=(2500, 3)) * (1.0 if case == "inside" else 4.0)
    query = np.concatenate([query, [[1e6, 0, 0], [-3e30, 1, 1]]]).astype(np.float32)
    q = torch.from_numpy(query)
    prep = pointcloud.nearest_prepare(torch.from_numpy(ref), q)
    ids = prep.query_id
    assert ids.dtype == torch.int64
    assert torch.equal(torch.sort(ids).values, torch.arange(len(query)))
    assert torch.equal(prep.query, q)
    assert torch.equal(prep.ref4[:, 3].view(torch.int32), prep.ref_id)
    cells = torch.floor(q[ids].double() * float(prep.inv)) - torch.tensor(prep.origin)
    span = torch.tensor(prep.span, dtype=torch.float64)
    cells = (torch.minimum(cells.clamp(min=-1), span) + 1).long()
    sx, sy, sz = (s + 2 for s in prep.span)
    key = (cells[:, 0] * sy + cells[:, 1]) * sz + cells[:, 2]
    assert (key.diff() >= 0).all()
    got = pointcloud.nearest_query_keys(q, prep.inv, np.array(prep.origin), prep.span)
    assert torch.equal(got[ids].long(), key)
    assert int((key.diff() == 0).sum()) > len(query) // 4   # runs share cells
    # the kernel's write-back: a result computed in sorted order lands at
    # the query's own index
    sorted_result = torch.arange(len(query)) * 7
    back = torch.empty(len(query), dtype=torch.int64)
    back[ids] = sorted_result
    assert torch.equal(back[ids], sorted_result)
    assert torch.equal(back, ids.argsort() * 7)


def _faces(v, r, s):
    """csrc: nn_faces, the cells v - r and v + r inside 0..s-1."""
    return [c for c in (v - r, v + r) if 0 <= c < s]


def _span(v, d, s):
    """csrc: nn_span, the cells of v - d..v + d inside 0..s-1."""
    return list(range(max(v - d, 0), min(v + d, s - 1) + 1))


def shell_cells(q, r, span):
    """A model of csrc's nn_shell_warp (r >= 1): the items its lanes split
    and the grid cells each item's run covers. Returns (items, cells)."""
    (qx, qy, qz), (sx, sy, sz) = q, span
    fx, fy, fz = _faces(qx, r, sx), _faces(qy, r, sy), _faces(qz, r, sz)
    ys, xi, yi = _span(qy, r, sy), _span(qx, r - 1, sx), _span(qy, r - 1, sy)
    rows = ([(x, y, qz - r, qz + r) for x in fx for y in ys]
            + [(x, y, qz - r, qz + r) for y in fy for x in xi]
            + [(x, y, z, z) for z in fz for x in xi for y in yi])
    cells = [(x, y, z) for x, y, z0, z1 in rows
             for z in range(max(z0, 0), min(z1, sz - 1) + 1)]
    return len(rows), cells


@pytest.mark.parametrize("q", [(2, 3, 4), (0, 0, 0), (6, -1, 3), (-3, 9, 12),
                               (100_004, 2, 3), (-100_000, -100_000, 100_006),
                               (3, 100_000, -7)])
def test_nearest_shell_stays_in_the_grid(q):
    """K3's warp walk clips each shell to the grid before it splits the
    shell's runs over the lanes: the runs cover every grid cell at
    Chebyshev distance r from the query's cell once and no other, and
    their count is bounded by the grid's columns, not by r, for a query
    inside the grid, just outside it, or 10^5 cells out."""
    span = (7, 8, 9)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in span), indexing="ij"), -1).reshape(-1, 3)
    cheb = np.abs(grid - np.array(q)).max(1)
    gap = int(cheb.min())
    for r in range(max(gap, 1), int(cheb.max()) + 1):
        items, cells = shell_cells(q, r, span)
        assert len(cells) == len(set(cells))
        assert set(cells) == {tuple(c) for c in grid[cheb == r].tolist()}
        assert items <= 2 * span[1] + 2 * span[0] + 2 * span[0] * span[1]
    if gap >= 2:   # a shell inside the gap covers no grid cell
        assert shell_cells(q, gap - 1, span)[1] == []


def test_morton_codes_interleave():
    c = torch.tensor([[0, 0, 1], [0, 1, 0], [1, 0, 0], [1023, 1023, 1023], [3, 5, 6]])
    got = pointcloud.morton3(c).tolist()
    assert got[:3] == [1, 2, 4] and got[3] == (1 << 30) - 1
    x, y, z = 3, 5, 6
    want = sum(((x >> i & 1) << (3 * i + 2)) | ((y >> i & 1) << (3 * i + 1))
               | ((z >> i & 1) << (3 * i)) for i in range(10))
    assert got[4] == want
