"""K2 and K3, the port's point-cloud searches, as hand-written CUDA kernels
(csrc/pointcloud.cu), and the voxel dedup on the device.

No Pallas kernel stands behind them. They replace the JAX package's host
C++ (native/pointcloud.cpp, loaded there through ctypes), which the port
does not load:

- K2, `knn_mean_dist` (native/pointcloud.cpp:67-127): each point's mean
  distance to its k nearest neighbours under the native search's ring
  rule, which is not an exact k-NN. The grid's cell comes from the
  bounding box of all points, `cell = max(cbrt(vol * 2k / 27n), diag *
  1e-6)` in float32, and a point's cell is floor(p / cell). The
  candidates of every point of a cell are the points in the cube of
  Chebyshev radius R around it, where R is one more than the first ring
  r in 1..9 whose cube holds at least k other points, and 9 at most: a
  property of the cell. The result is the mean of the square roots of
  the kk = min(k, candidates) smallest squared distances, summed in
  ascending order; 0 where kk is 0, and all zeros when n <= k. So the
  points the k-NN filter keeps are the JAX package's, up to the FMA
  contraction of its build (2.6e-7 relative).
- K3, `nearest_index` (native/pointcloud.cpp:136-235): the exact nearest
  reference point of each query; among equal squared distances (computed
  without FMA) the lowest index. On the card a shell search over a dense
  grid of the reference points (`nearest_prepare` builds it: the native
  search's cell size, the points sorted by cell and a table of each
  cell's first point; the queries ordered by the linear key of their
  cell, so that a block stages its neighbourhood once for all of them);
  the plain version is a brute force.
- `voxel_first_indices` (native/pointcloud.cpp:49-61): the first point of
  every occupied floor(p / voxel) cell, in ascending order. Torch ops (a
  unique and an "amin" scatter), not a kernel.

Around K2, the grid (its scalars, the cell keys, the sort of the points by
cell, each cell's start, count and R) is torch glue shared by the kernel
and its plain version, `cell_grid`; `knn_prepare` adds what the kernel's
skip needs: the points sorted inside each cell by the Morton code of their
sub-cell (`knn_order`), cut into chunks with their boxes (`knn_chunks`),
the cells' boxes, and the blocks' order, heaviest cube first. The skip's
bound is `box_lower_bound`. Each glue pulls from the card only what sizes
its arrays: (K2) the points' box, the cells, the cells still open after
the first ring group, and the chunks; (K3) the reference points' and the
queries' boxes at once, which also shows them finite. The wrappers
`knn_mean_dist` and `nearest_index` take a CPU tensor to the plain version
and launch the kernel on a CUDA tensor or raise; `counts` records which
ran. The kernels are compiled on first use with nvcc into
recon3d_tpu_torch/_build (a plain C entry point, loaded with ctypes), never
when this module is imported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.kernels.build import build_library
from recon3d_tpu_torch.kernels.warp import NVCC_FLAGS, nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pointcloud.cu"
RING_MAX = 9          # the native search's widest ring
KNN_CHUNK = 128       # K2: most points of a chunk, its blocks' queries and its
                      # candidate tiles (csrc: KNN_CHUNK)
KNN_SUB_BITS = 10     # K2: sub-cell resolution (bits an axis) of the sort in a cell
KNN_REGISTER_K = 31   # K2 keeps k + 1 squared distances in registers up to here,
                      # beyond in a row of global scratch a point
NN_THREADS = 128      # K3: sorted queries a block takes (csrc: NN_THREADS)
NN_MAX_CELLS = 1 << 26   # K3's dense cell table (the diag / 256 floor keeps 258^3)
# Elements of one plain-version distance matrix (rows x candidates).
PLAIN_CHUNK = 1 << 24
# Cell lookups of one glue step (cells x shell offsets).
LOOKUP_CHUNK = 1 << 22
# The grid's rings are counted in these groups: every cell takes the first
# (most stop there), the cells it leaves open the second.
RING_GROUPS = ((1, 3), (4, RING_MAX))


@dataclass
class Counts:
    """How often a wrapper launched its kernel and took the plain version."""

    kernel: int = 0
    plain: int = 0


counts: Dict[str, Counts] = {"knn_mean_dist": Counts(), "nearest_index": Counts()}


def reset_counts() -> None:
    for c in counts.values():
        c.kernel = c.plain = 0


def snapshot() -> Dict[str, Dict[str, int]]:
    """{kernel name: {"kernel": launches, "plain": plain calls}} now."""
    return {name: {"kernel": c.kernel, "plain": c.plain} for name, c in counts.items()}


def since(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """The launches and plain calls of each kernel since `snapshot()` gave
    `before` (the CLIs' --stats-json)."""
    now = snapshot()
    return {name: {key: now[name][key] - before[name][key] for key in ("kernel", "plain")}
            for name in now}


# ---- the glue: the native search's grid ----------------------------------


def grid_scalars(lo: np.ndarray, hi: np.ndarray, n: int, k: int) -> np.float32:
    """1 / cell of native/pointcloud.cpp:74-88 from the box's corners: every
    operation rounded in float32 in the C code's order."""
    f = np.float32
    ext = [f(hi[d] - lo[d]) for d in range(3)]
    diag = f(0)
    for e in ext:
        diag = f(diag + f(e * e))
    diag = f(np.sqrt(max(diag, f(1e-12))))
    vol = max(f(f(ext[0] * ext[1]) * ext[2]), f(1e-12))
    cell = f(np.cbrt(f(f(vol * f(f(2) * f(k))) / f(f(27) * f(n)))))
    cell = max(cell, f(diag * f(1e-6)))
    return f(f(1) / cell)


def cell_coords(points: torch.Tensor, inv: np.float32) -> torch.Tensor:
    """(n, 3) int64 floor(p * inv), the product rounded in float32 as in
    native/pointcloud.cpp:35-41. Raises where the C code's cast to int64
    would be undefined (non-finite points, cells beyond 2^62)."""
    scaled = torch.floor(points * torch.tensor(inv, dtype=torch.float32, device=points.device))
    if not bool(torch.isfinite(scaled).all()) or bool((scaled.abs() > 2.0 ** 62).any()):
        raise ValueError("point-cloud grid: points must be finite, with cells below 2^62")
    return scaled.to(torch.int64)


def point_box(points: torch.Tensor) -> np.ndarray:
    """(2, 3) float32 [min, max] of the points on the host: one pull."""
    return torch.stack([points.min(0).values, points.max(0).values]).cpu().numpy()


def morton3(c: torch.Tensor) -> torch.Tensor:
    """(n,) int64 Morton codes of (n, 3) int64 coordinates in 0..1023, x
    the most significant of each triple."""
    x = c & 0x3FF   # the three axes at once: each one's bits two apart
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return (x[:, 0] << 2) | (x[:, 1] << 1) | x[:, 2]


@dataclass
class CellGrid:
    """The native k-NN search's grid over n points, cells sorted by key."""

    order: torch.Tensor   # (n,) point indices sorted by cell
    key: torch.Tensor     # (C,) int64 linear cell keys, ascending
    start: torch.Tensor   # (C,) int64 first position of the cell in `order`
    count: torch.Tensor   # (C,) int64 points in the cell
    ring: torch.Tensor    # (C,) int64 R, the Chebyshev radius of its candidates
    cube: torch.Tensor    # (C,) int64 points in its R-cube, its own included
    steps: Tuple[int, int]  # key steps of one cell along x and y (z: 1)
    inv: np.float32       # 1 / cell

    def candidate_pairs(self) -> int:
        """Squared distances the ring rule evaluates: each point against the
        other points of its cell's R-cube."""
        return int((self.count * (self.cube - 1)).sum())

    def offsets(self, r: int, shell: bool) -> torch.Tensor:
        """Key offsets of the cells at Chebyshev distance r (shell) or at
        most r (cube), x slowest and z fastest."""
        d = torch.arange(-r, r + 1, device=self.key.device)
        dx, dy, dz = torch.meshgrid(d, d, d, indexing="ij")
        off = dx * self.steps[0] + dy * self.steps[1] + dz
        if not shell:
            return off.reshape(-1)
        return off[torch.maximum(dx.abs(), torch.maximum(dy.abs(), dz.abs())) == r]

    def lookup(self, keys: torch.Tensor) -> torch.Tensor:
        """Index of the cell of each key, -1 where no point lies."""
        pos = torch.searchsorted(self.key, keys).clamp_(max=len(self.key) - 1)
        return torch.where(self.key[pos] == keys, pos, -1)

    def ring_counts(self, cells: torch.Tensor, ra: int, rb: int) -> torch.Tensor:
        """(len(cells), rb - ra + 1) int64: the points in the shells ra..r
        (Chebyshev distance) around each of the cells, for r = ra..rb."""
        d = np.arange(-rb, rb + 1)
        dx, dy, dz = (a.reshape(-1) for a in np.meshgrid(d, d, d, indexing="ij"))
        cheb = np.maximum(np.abs(dx), np.maximum(np.abs(dy), np.abs(dz)))
        sel = np.flatnonzero(cheb >= ra)
        sel = sel[np.argsort(cheb[sel], kind="stable")]   # ring by ring
        ends = np.cumsum(np.bincount(cheb[sel] - ra)) - 1   # each ring's last offset
        dev = self.key.device
        off = torch.as_tensor(dx[sel] * self.steps[0] + dy[sel] * self.steps[1] + dz[sel],
                              device=dev)
        ends = torch.as_tensor(ends, device=dev)
        out = torch.zeros((len(cells), rb - ra + 1), dtype=torch.int64, device=dev)
        step = max(1, LOOKUP_CHUNK // len(off))
        for i in range(0, len(cells), step):
            pos = self.lookup(self.key[cells[i:i + step], None] + off)
            got = torch.where(pos >= 0, self.count[pos.clamp(min=0)], 0)
            out[i:i + step] = torch.cumsum(got, 1)[:, ends]
        return out


def cell_grid(points: torch.Tensor, k: int) -> CellGrid:
    """The grid of native/pointcloud.cpp:74-127 over (n, 3) float32 points
    (n > k), on their device. Cell keys are linear in the cell coordinates
    shifted by their minimum, with RING_MAX empty cells of margin on each
    side so that a cube's offsets never wrap; the range is checked (the
    diag * 1e-6 floor on the cell keeps it below 1e6 + 21 cells an axis).
    The cells' range comes from the points' box, pulled once: floor(p *
    inv) rises with p."""
    n = len(points)
    lo, hi = point_box(points)
    if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
        raise ValueError("point-cloud grid: points must be finite, with cells below 2^62")
    inv = grid_scalars(lo, hi, n, k)
    c_lo, c_hi = np.floor(lo * inv), np.floor(hi * inv)   # float32 products, as the points'
    if max(np.abs(c_lo).max(), np.abs(c_hi).max()) > 2.0 ** 62:
        raise ValueError("point-cloud grid: points must be finite, with cells below 2^62")
    cmin = [int(v) - RING_MAX for v in c_lo]
    span = [int(c_hi[d]) - cmin[d] + RING_MAX + 1 for d in range(3)]
    if span[0] * span[1] * span[2] >= 2 ** 62:
        raise ValueError(f"point-cloud grid: {span} cells do not fit a 62-bit key")
    rel = torch.floor(points * torch.tensor(inv, dtype=torch.float32, device=points.device))
    rel = rel.to(torch.int64) - torch.tensor(cmin, device=points.device)
    lin = (rel[:, 0] * span[1] + rel[:, 1]) * span[2] + rel[:, 2]
    order = torch.argsort(lin, stable=True)
    key, count = torch.unique_consecutive(lin[order], return_counts=True)
    start = torch.cumsum(count, 0) - count
    grid = CellGrid(order, key, start, count, torch.full_like(count, RING_MAX),
                    count.clone(), (span[1] * span[2], span[2]), inv)
    # Rings 1..9: a cell whose ring r first holds k other points takes one
    # more ring (R = r + 1), 9 at most; its cube counts the shells to R.
    # The rings of a group are counted at once; a cell still open at a
    # group's end (no ring found yet, or found at its last) goes on.
    todo = torch.arange(len(key), device=points.device)
    before = count                       # points through the previous group's rings
    found = torch.zeros(len(key), dtype=torch.bool, device=points.device)   # ... at its last
    for ra, rb in RING_GROUPS:
        if len(todo) == 0:
            break
        cum = before[:, None] + grid.ring_counts(todo, ra, rb)
        nr = rb - ra + 1
        first = (cum - 1 < k).sum(1)   # the first ring that holds k others (nr: none)
        j = torch.where(found, 0, first + 1)        # R - ra
        last = rb == RING_MAX
        done = torch.ones_like(found) if last else j < nr
        j = j.clamp(max=nr - 1)
        grid.ring[todo] = torch.where(done, ra + j, RING_MAX)
        grid.cube[todo] = torch.where(done, cum.gather(1, j[:, None])[:, 0], cum[:, -1])
        if last:
            break
        keep = ~done
        todo, before, found = todo[keep], cum[keep, -1], (first == nr - 1)[keep]
    return grid


def _check_points(points: torch.Tensor, what: str) -> None:
    if points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"{what}: points must be (n, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {points.device}")


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"knn_mean_dist: k must be at least 1, got {k}")


# ---- K2 -------------------------------------------------------------------


def knn_mean_dist_reference(points: torch.Tensor, k: int,
                            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K2 on the points' device: cell by cell, the
    squared distances of its points to its R-cube's ((dx*dx + dy*dy) +
    dz*dz, each operation rounded), the point itself excluded by index, the
    k smallest, and their square roots summed in ascending order. `rows`
    (int64 indices) computes only those points' values, in that order."""
    _check_points(points, "knn_mean_dist")
    _check_k(k)
    n = len(points)
    targets = torch.arange(n, device=points.device) if rows is None else rows
    out = torch.zeros(len(targets), dtype=torch.float32, device=points.device)
    if n <= k or len(targets) == 0:
        return out
    grid = cell_grid(points, k)
    pos = torch.empty_like(grid.order)
    pos[grid.order] = torch.arange(n, device=points.device)
    cell_of = torch.repeat_interleave(torch.arange(len(grid.key), device=points.device),
                                      grid.count)[pos[targets]]
    by_cell = torch.argsort(cell_of, stable=True)
    cells, per_cell = torch.unique_consecutive(cell_of[by_cell], return_counts=True)
    sorted_pts = points[grid.order]
    first = 0
    for c, m in zip(cells.tolist(), per_cell.tolist()):
        mine = by_cell[first:first + m]
        first += m
        nb = grid.lookup(grid.key[c] + grid.offsets(int(grid.ring[c]), shell=False))
        nb = nb[nb >= 0]
        cand = torch.cat([torch.arange(int(s), int(s + t), device=points.device)
                          for s, t in zip(grid.start[nb].tolist(), grid.count[nb].tolist())])
        kk = min(k, len(cand) - 1)
        if kk == 0:
            continue
        cp = sorted_pts[cand]
        step = max(1, PLAIN_CHUNK // len(cand))
        for i in range(0, m, step):
            rows_i = mine[i:i + step]
            self_pos = pos[targets[rows_i]]
            q = sorted_pts[self_pos]
            dx = q[:, 0:1] - cp[None, :, 0]
            dy = q[:, 1:2] - cp[None, :, 1]
            dz = q[:, 2:3] - cp[None, :, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            d2[cand[None, :] == self_pos[:, None]] = torch.inf
            best = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values
            s = torch.zeros(len(rows_i), dtype=torch.float32, device=points.device)
            for j in range(kk):
                s = s + torch.sqrt(best[:, j])
            out[rows_i] = s / torch.full_like(s, float(kk))
    return out


def knn_order(points: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """(n,) point indices sorted by cell and, inside a cell, by the Morton
    code of their sub-cell (KNN_SUB_BITS bits an axis of floor(p * inv)'s
    fraction): each cell stays one run, at its start with its count, and a
    run of its points is compact in space."""
    n = len(points)
    cell = torch.empty(n, dtype=torch.int64, device=points.device)
    cell[grid.order] = torch.repeat_interleave(
        torch.arange(len(grid.key), device=points.device), grid.count, output_size=n)
    scaled = points * torch.tensor(grid.inv, dtype=torch.float32, device=points.device)
    side = 1 << KNN_SUB_BITS
    sub = ((scaled - torch.floor(scaled)) * side).to(torch.int64).clamp_(0, side - 1)
    return torch.argsort((cell << (3 * KNN_SUB_BITS)) | morton3(sub), stable=True)


def box_lower_bound(a_lo: torch.Tensor, a_hi: torch.Tensor, b_lo: torch.Tensor,
                    b_hi: torch.Tensor) -> torch.Tensor:
    """K2's skip bound (csrc: box_d2) between boxes (..., 3) float32: the gap
    on each axis, max(0, b_lo - a_hi, a_lo - b_hi), squared and summed with
    every operation rounded as a squared distance is. Rounding to nearest
    never decreases a larger argument's result, so for p in box a and q in
    box b every |p - q| rounds to at least the gap, and their squared
    distance to at least this bound: it is a lower bound with no margin."""
    g = torch.maximum(torch.clamp(b_lo - a_hi, min=0), a_lo - b_hi)
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]


@dataclass
class KnnLaunch:
    """K2's inputs on the card: the grid, the points sorted by knn_order as
    float4, its chunks (runs of up to KNN_CHUNK points of one cell, split
    evenly) with their boxes, the cells' boxes, and the blocks' order."""

    grid: CellGrid
    order: torch.Tensor        # (n,) knn_order
    pts4: torch.Tensor         # (n, 4) float32 in that order
    cell_chunk: torch.Tensor   # (C + 1,) int32 first chunk of each cell
    chunk_start: torch.Tensor  # (NC + 1,) int32 first sorted point of each chunk
    chunk_cell: torch.Tensor   # (NC,) int32 its cell
    chunk_box: torch.Tensor    # (NC, 2, 4) float32 lo, hi (w unused)
    cell_box: torch.Tensor     # (C, 2, 4) float32
    block_chunk: torch.Tensor  # (NC,) int32 the chunk of each block, heaviest cube first
    cells: Dict[str, torch.Tensor]   # int32 ring, cube
    k: int


def knn_chunks(grid: CellGrid, n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cell_chunk (C + 1,), chunk_cell (NC,), chunk_start (NC + 1,)) int64:
    each cell's run of the n points cut into ceil(count / KNN_CHUNK) chunks
    of even size."""
    dev = grid.key.device
    m = (grid.count + KNN_CHUNK - 1) // KNN_CHUNK
    cell_chunk = torch.zeros(len(m) + 1, dtype=torch.int64, device=dev)
    cell_chunk[1:] = torch.cumsum(m, 0)
    n_chunks = int(cell_chunk[-1])
    chunk_cell = torch.repeat_interleave(torch.arange(len(m), device=dev), m,
                                         output_size=n_chunks)
    i = torch.arange(n_chunks, device=dev) - cell_chunk[chunk_cell]
    chunk_start = torch.full((n_chunks + 1,), n, dtype=torch.int64, device=dev)
    chunk_start[:-1] = grid.start[chunk_cell] + i * grid.count[chunk_cell] // m[chunk_cell]
    return cell_chunk, chunk_cell, chunk_start


def _boxes(pts: torch.Tensor, group: torch.Tensor, groups: int) -> torch.Tensor:
    """(groups, 2, 4) float32 [min, max] of the (n, 3) points of each group."""
    idx = group[:, None].expand(-1, 3)
    box = torch.zeros((groups, 2, 4), dtype=torch.float32, device=pts.device)
    box[:, 0, :3] = torch.full((groups, 3), torch.inf, device=pts.device).scatter_reduce(
        0, idx, pts, "amin")
    box[:, 1, :3] = torch.full((groups, 3), -torch.inf, device=pts.device).scatter_reduce(
        0, idx, pts, "amax")
    return box


def knn_prepare(points: torch.Tensor, k: int) -> KnnLaunch:
    """The glue of K2 for n > k CUDA points: the grid and the launch's arrays."""
    grid = cell_grid(points, k)
    n, dev = len(points), points.device
    order = knn_order(points, grid)
    sorted_pts = points[order]
    pts4 = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    pts4[:, :3] = sorted_pts
    cell_chunk, chunk_cell, chunk_start = knn_chunks(grid, n)
    n_chunks = len(chunk_cell)
    chunk_of = torch.repeat_interleave(torch.arange(n_chunks, device=dev),
                                       chunk_start.diff(), output_size=n)
    chunk_box = _boxes(sorted_pts, chunk_of, n_chunks)
    cell_of = torch.repeat_interleave(torch.arange(len(grid.key), device=dev), grid.count,
                                      output_size=n)
    cell_box = _boxes(sorted_pts, cell_of, len(grid.key))
    block_chunk = torch.argsort(-grid.cube[chunk_cell], stable=True)   # heaviest first
    i32 = torch.int32
    return KnnLaunch(grid, order, pts4, cell_chunk.to(i32), chunk_start.to(i32),
                     chunk_cell.to(i32), chunk_box, cell_box, block_chunk.to(i32),
                     {"ring": grid.ring.to(i32), "cube": grid.cube.to(i32)}, k)


def knn_launch(prep: KnnLaunch, pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 on prepared inputs; (n,) float32 in the points' order.
    `pairs`, a (1,) int64 CUDA tensor, gains the squared distances the
    kernel evaluated between a point and another (at most
    grid.candidate_pairs())."""
    n, g = len(prep.pts4), prep.grid
    out_sorted = torch.empty(n, dtype=torch.float32, device=prep.pts4.device)
    wide = None
    if prep.k > KNN_REGISTER_K:
        wide = torch.empty(n * (prep.k + 1), dtype=torch.float32, device=prep.pts4.device)
    lib = _library()
    with torch.cuda.device(prep.pts4.device):
        stream = torch.cuda.current_stream(prep.pts4.device).cuda_stream
        rc = lib.knn_mean_dist_launch(
            prep.pts4.data_ptr(), g.key.data_ptr(), prep.cells["ring"].data_ptr(),
            prep.cells["cube"].data_ptr(), prep.cell_chunk.data_ptr(),
            prep.cell_box.data_ptr(), len(g.key), prep.chunk_start.data_ptr(),
            prep.chunk_box.data_ptr(), prep.chunk_cell.data_ptr(),
            prep.block_chunk.data_ptr(), len(prep.block_chunk), g.steps[0], g.steps[1],
            prep.k, None if wide is None else wide.data_ptr(), out_sorted.data_ptr(),
            None if pairs is None else pairs.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"knn_mean_dist kernel launch failed (n={n}, k={prep.k}, "
                           f"{len(prep.block_chunk)} blocks): CUDA error {rc}")
    counts["knn_mean_dist"].kernel += 1
    out = torch.empty_like(out_sorted)
    out[prep.order] = out_sorted
    return out


def knn_mean_dist(points: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) float32 mean distance of each of the (n, 3) float32 points to its
    k nearest neighbours under the ring rule: K2 on a CUDA tensor, the
    plain version on a CPU tensor; all zeros, and neither, when n <= k."""
    _check_points(points, "knn_mean_dist")
    _check_k(k)
    n = len(points)
    if n <= k:
        return torch.zeros(n, dtype=torch.float32, device=points.device)
    if points.device.type == "cpu":
        counts["knn_mean_dist"].plain += 1
        return knn_mean_dist_reference(points, k)
    if n >= 2 ** 31:
        raise ValueError(f"knn_mean_dist: K2 indexes points with 32 bits, got {n}")
    return knn_launch(knn_prepare(points.contiguous(), k))


# ---- K3 -------------------------------------------------------------------


def nearest_index_reference(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: the squared distance of each query to
    every reference point ((dx*dx + dy*dy) + dz*dz, each operation
    rounded) and its first minimum, in chunks of queries."""
    out = torch.empty(len(query), dtype=torch.int64, device=query.device)
    step = max(1, PLAIN_CHUNK // max(len(ref), 1))
    for i in range(0, len(query), step):
        q = query[i:i + step]
        dx = q[:, 0:1] - ref[None, :, 0]
        dy = q[:, 1:2] - ref[None, :, 1]
        dz = q[:, 2:3] - ref[None, :, 2]
        out[i:i + step] = ((dx * dx + dy * dy) + dz * dz).argmin(1)
    return out


def nn_grid_scalar(lo: np.ndarray, hi: np.ndarray, n: int) -> np.float32:
    """1 / cell of K3's grid over n reference points in the box lo..hi: the
    native search's cell (native/pointcloud.cpp:159-175), about two points a
    cell for uniform density and at least diag / 256, in float32."""
    f = np.float32
    ext = [f(hi[d] - lo[d]) for d in range(3)]
    diag2 = f(0)
    for e in ext:
        diag2 = f(diag2 + f(e * e))
    diag = f(np.sqrt(max(diag2, f(1e-12))))
    vol = max(f(f(ext[0] * ext[1]) * ext[2]), f(1e-12))
    cell = max(f(np.cbrt(f(f(vol * f(2)) / f(n)))), f(diag / f(256)))
    return f(f(1) / cell)


@dataclass
class NearestLaunch:
    """K3's inputs on the card: the reference points sorted by cell (float4,
    w the bits of each one's original index), the dense cell table, and the
    queries in the callers' order with the order the kernel takes them in:
    by the linear key of their cell."""

    ref4: torch.Tensor         # (n, 4) float32, sorted by cell; w: int32 bits of ref_id
    ref_id: torch.Tensor       # (n,) int32 original index of each
    cell_first: torch.Tensor   # (sx * sy * sz + 1,) int32 first sorted point of each cell
    span: Tuple[int, int, int]   # cells along x, y, z
    inv: np.float32            # 1 / cell
    origin: Tuple[float, float, float]   # the first cell's floor(p * inv)
    query: torch.Tensor        # (m, 3) float32, the callers' order
    query_id: torch.Tensor     # (m,) int64 the queries in the kernel's order


def nearest_query_keys(query: torch.Tensor, inv: np.float32, origin: np.ndarray,
                       span: Tuple[int, int, int]) -> torch.Tensor:
    """(m,) int32 linear key of each query's cell floor(p * inv) - origin
    (the product in float64, exact) clamped to one cell beyond the grid, on
    a grid of span + 2 cells an axis: x slowest, z fastest. Every value is
    an integer below 2^31, so the float64 sum is exact."""
    dev = query.device
    sx, sy, sz = (s + 2 for s in span)
    cells = torch.floor(query.double() * float(inv)) - torch.tensor(
        origin - 1, dtype=torch.float64, device=dev)
    cells = torch.clamp(cells, torch.zeros(3, dtype=torch.float64, device=dev),
                        torch.tensor([sx - 1, sy - 1, sz - 1], dtype=torch.float64, device=dev))
    step = torch.tensor([sy * sz, sz, 1], dtype=torch.float64, device=dev)
    return (cells * step).sum(1).to(torch.int32)


def nearest_prepare(ref: torch.Tensor, query: torch.Tensor) -> NearestLaunch:
    """The glue of K3 for n >= 1 reference points: the grid, its cells
    floor(p * inv) with the product taken in float64, where it is exact, as
    the kernel takes it for the queries. The grid's origin and span come
    from the reference points' box, pulled once with the queries' box
    (raises unless both are finite; the exact product rises with p). The
    queries stay in the callers' order; query_id sorts them by the linear
    key of their cell (nearest_query_keys), so that a block's run of them
    is compact, and the kernel writes each result at its query's index."""
    n, dev = len(ref), ref.device
    parts = [ref.amin(0), ref.amax(0)]
    if len(query):
        parts += [query.amin(0), query.amax(0)]
    box = torch.stack(parts).cpu().numpy()   # min and max propagate NaN
    if not np.isfinite(box).all():
        raise ValueError("nearest_index: points must be finite")
    lo, hi = box[0], box[1]
    inv = nn_grid_scalar(lo, hi, n)
    origin = np.floor(lo.astype(np.float64) * float(inv))
    span = tuple(int(v) for v in np.floor(hi.astype(np.float64) * float(inv)) - origin + 1)
    total = span[0] * span[1] * span[2]
    if total > NN_MAX_CELLS:
        raise ValueError(f"nearest_index: a grid of {span} cells exceeds {NN_MAX_CELLS}")
    rel = torch.floor(ref.double() * float(inv)) - torch.tensor(origin, dtype=torch.float64,
                                                                device=dev)
    step = torch.tensor([span[1] * span[2], span[2], 1], dtype=torch.float64, device=dev)
    lin = (rel * step).sum(1).to(torch.int32)   # exact: integers below NN_MAX_CELLS
    order = torch.argsort(lin, stable=True).to(torch.int32)
    first = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    first[1:] = torch.cumsum(torch.bincount(lin, minlength=total), 0)
    ref4 = torch.empty((n, 4), dtype=torch.float32, device=dev)
    ref4[:, :3] = ref[order]
    ref4[:, 3] = order.view(torch.float32)
    q_order = torch.argsort(nearest_query_keys(query, inv, origin, span), stable=True)
    return NearestLaunch(ref4, order, first, span, inv, tuple(float(c) for c in origin),
                         query, q_order)


def nearest_launch(prep: NearestLaunch, pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 on prepared CUDA inputs (m >= 1); (m,) int64 in the
    queries' order. One call, two kernels: the blocks' stages, then the
    walks they leave (a warp a walk); `counts` takes one. `pairs`, a (1,)
    int64 CUDA tensor, gains the squared distances the search evaluated."""
    n, m = len(prep.ref4), len(prep.query)
    dev = prep.ref4.device
    out = torch.empty(m, dtype=torch.int64, device=dev)
    walks = torch.empty(4 * m + 1, dtype=torch.int32, device=dev)   # then their count
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nearest_index_launch(
            prep.ref4.data_ptr(), prep.cell_first.data_ptr(), n, *prep.span,
            float(prep.inv), *prep.origin, prep.query.data_ptr(), prep.query_id.data_ptr(),
            m, out.data_ptr(), walks.data_ptr(), None if pairs is None else pairs.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"nearest_index kernel launch failed (n={n}, m={m}, grid "
                           f"{prep.span}): CUDA error {rc}")
    counts["nearest_index"].kernel += 1
    return out


def nearest_index(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(m,) int64 index of the nearest of the (n, 3) float32 `ref` points for
    each of the (m, 3) float32 `query` points (n >= 1), the lowest index
    among equal squared distances: K3 on CUDA tensors, the plain version on
    CPU tensors. Raises on points that are not finite."""
    _check_points(ref, "nearest_index")
    _check_points(query, "nearest_index")
    if ref.device != query.device:
        raise ValueError(f"nearest_index: ref on {ref.device}, query on {query.device}")
    if len(ref) == 0 and len(query):
        raise ValueError("nearest_index: no reference points")
    if ref.device.type == "cpu" or len(query) == 0:
        if not (bool(torch.isfinite(ref).all()) and bool(torch.isfinite(query).all())):
            raise ValueError("nearest_index: points must be finite")
    if ref.device.type == "cpu":
        counts["nearest_index"].plain += 1
        return nearest_index_reference(ref, query)
    if max(len(ref), len(query)) >= 2 ** 31:
        raise ValueError(f"nearest_index: K3 indexes points with 32 bits, got "
                         f"{len(ref)}, {len(query)}")
    if len(query) == 0:
        return torch.empty(0, dtype=torch.int64, device=query.device)
    # the finite check rides on nearest_prepare's one pull of the boxes
    return nearest_launch(nearest_prepare(ref.contiguous(), query.contiguous()))


# ---- the voxel dedup (torch ops) -------------------------------------------


def voxel_first_indices(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """Ascending int64 indices of the first point of every occupied voxel of
    size `voxel` (rounded to float32, as the C code takes it), on the
    points' device."""
    _check_points(points, "voxel_first_indices")
    n = len(points)
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=points.device)
    cells = cell_coords(points, np.float32(1) / np.float32(voxel))
    uniq, inverse = torch.unique(cells, dim=0, return_inverse=True)
    first = torch.full((len(uniq),), n, dtype=torch.int64, device=points.device)
    first.scatter_reduce_(0, inverse, torch.arange(n, device=points.device), "amin")
    return torch.sort(first).values


# ---- the library ------------------------------------------------------------

_lib = None


def build() -> Tuple[Path, float, str]:
    """Compile csrc/pointcloud.cu into a shared library unless an identical
    build exists. Returns (library path, seconds spent compiling, nvcc's log)."""
    return build_library(SOURCE, "pointcloud", nvcc(), NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.knn_mean_dist_launch.restype = ctypes.c_int
        lib.knn_mean_dist_launch.argtypes = [
            ctypes.c_void_p,     # points in knn_order, (n, 4) float32
            ctypes.c_void_p,     # cell keys, (C,) int64 ascending
            ctypes.c_void_p,     # cell rings R, (C,) int32
            ctypes.c_void_p,     # points in each cell's R-cube, (C,) int32
            ctypes.c_void_p,     # first chunk of each cell, (C + 1,) int32
            ctypes.c_void_p,     # cell boxes, (C, 2, 4) float32
            ctypes.c_int,        # C
            ctypes.c_void_p,     # first point of each chunk, (NC + 1,) int32
            ctypes.c_void_p,     # chunk boxes, (NC, 2, 4) float32
            ctypes.c_void_p,     # the cell of each chunk, (NC,) int32
            ctypes.c_void_p,     # the chunk of each block, (NC,) int32
            ctypes.c_int,        # NC, the blocks
            ctypes.c_longlong,   # key step of one cell along x
            ctypes.c_longlong,   # key step along y
            ctypes.c_int,        # k
            ctypes.c_void_p,     # scratch, n * (k + 1) float32 where k > KNN_REGISTER_K
            ctypes.c_void_p,     # out, (n,) float32 in sorted order
            ctypes.c_void_p,     # pairs evaluated, (1,) int64, or null
            ctypes.c_void_p,     # stream
        ]
        lib.nearest_index_launch.restype = ctypes.c_int
        lib.nearest_index_launch.argtypes = [
            ctypes.c_void_p,     # ref sorted by cell, (n, 4) float32, w its index's bits
            ctypes.c_void_p,     # cell table, (sx * sy * sz + 1,) int32
            ctypes.c_int,        # n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # sx, sy, sz
            ctypes.c_float,      # inv
            ctypes.c_double, ctypes.c_double, ctypes.c_double,   # the grid's origin cell
            ctypes.c_void_p,     # queries, (m, 3) float32
            ctypes.c_void_p,     # the order the kernel takes them in, (m,) int64
            ctypes.c_int,        # m
            ctypes.c_void_p,     # out, (m,) int64 at the original indices
            ctypes.c_void_p,     # scratch for the walks and their count, (4 m + 1,) int32
            ctypes.c_void_p,     # pairs evaluated, (1,) int64, or null
            ctypes.c_void_p,     # stream
        ]
        _lib = lib
    return _lib
