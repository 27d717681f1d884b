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
  cell's first point); the plain version is a brute force.
- `voxel_first_indices` (native/pointcloud.cpp:49-61): the first point of
  every occupied floor(p / voxel) cell, in ascending order. Torch ops (a
  unique and an "amin" scatter), not a kernel.

Around K2, the grid (its scalars, the cell keys, the sort of the points by
cell, each cell's start, count and R) is torch glue shared by the kernel
and its plain version, `cell_grid`. The wrappers `knn_mean_dist` and
`nearest_index` take a CPU tensor to the plain version and launch the
kernel on a CUDA tensor or raise; `counts` records which ran. The kernels
are compiled on first use with nvcc into recon3d_tpu_torch/_build (a plain
C entry point, loaded with ctypes), never when this module is imported.
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
KNN_THREADS = 128     # query points of a cell a K2 block takes (csrc: KNN_THREADS)
KNN_REGISTER_K = 31   # K2 keeps k + 1 squared distances in registers up to here,
                      # beyond in a row of global scratch a point
NN_MAX_CELLS = 1 << 26   # K3's dense cell table (the diag / 256 floor keeps 258^3)
# Elements of one plain-version distance matrix (rows x candidates).
PLAIN_CHUNK = 1 << 24
# Cell lookups of one glue step (cells x shell offsets).
LOOKUP_CHUNK = 1 << 22


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


def cell_grid(points: torch.Tensor, k: int) -> CellGrid:
    """The grid of native/pointcloud.cpp:74-127 over (n, 3) float32 points
    (n > k), on their device. Cell keys are linear in the cell coordinates
    shifted by their minimum, with RING_MAX empty cells of margin on each
    side so that a cube's offsets never wrap; the range is checked (the
    diag * 1e-6 floor on the cell keeps it below 1e6 + 21 cells an axis)."""
    n = len(points)
    lo = points.min(0).values.cpu().numpy()
    hi = points.max(0).values.cpu().numpy()
    cells = cell_coords(points, grid_scalars(lo, hi, n, k))
    cmin = cells.min(0).values - RING_MAX
    span = [int(s) for s in (cells.max(0).values - cmin + RING_MAX + 1).cpu()]
    if span[0] * span[1] * span[2] >= 2 ** 62:
        raise ValueError(f"point-cloud grid: {span} cells do not fit a 62-bit key")
    rel = cells - cmin
    lin = (rel[:, 0] * span[1] + rel[:, 1]) * span[2] + rel[:, 2]
    order = torch.argsort(lin, stable=True)
    key, count = torch.unique_consecutive(lin[order], return_counts=True)
    start = torch.cumsum(count, 0) - count
    grid = CellGrid(order, key, start, count, torch.full_like(count, RING_MAX),
                    count.clone(), (span[1] * span[2], span[2]))
    # Rings 1..9: the cube's count grows by each shell's. A cell whose ring
    # r first holds k other points takes one more ring (R = r + 1) and stops.
    todo = torch.arange(len(key), device=points.device)
    found = torch.zeros(len(key), dtype=torch.bool, device=points.device)
    for r in range(1, RING_MAX + 1):
        if len(todo) == 0:
            break
        off = grid.offsets(r, shell=True)
        step = max(1, LOOKUP_CHUNK // len(off))
        for i in range(0, len(todo), step):
            cells_i = todo[i:i + step]
            pos = grid.lookup(key[cells_i, None] + off)
            grid.cube[cells_i] += torch.where(pos >= 0, count[pos.clamp(min=0)], 0).sum(1)
        extra = found[todo]
        grid.ring[todo[extra]] = r
        found[todo[grid.cube[todo] - 1 >= k]] = True
        todo = todo[~extra]
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


@dataclass
class KnnLaunch:
    """K2's inputs on the card: the grid, the points in cell order as
    float4, and the blocks (a cell and the first of its points each)."""

    grid: CellGrid
    pts4: torch.Tensor
    cells: Dict[str, torch.Tensor]   # int32 start, count, ring; item_cell, item_first
    k: int


def knn_prepare(points: torch.Tensor, k: int) -> KnnLaunch:
    """The glue of K2 for n > k CUDA points: the grid and the launch's arrays."""
    grid = cell_grid(points, k)
    n = len(points)
    pts4 = torch.zeros((n, 4), dtype=torch.float32, device=points.device)
    pts4[:, :3] = points[grid.order]
    blocks = (grid.count + KNN_THREADS - 1) // KNN_THREADS
    item_cell = torch.repeat_interleave(torch.arange(len(grid.key), device=points.device),
                                        blocks)
    item_first = (torch.arange(len(item_cell), device=points.device)
                  - torch.repeat_interleave(torch.cumsum(blocks, 0) - blocks, blocks)) * KNN_THREADS
    cells = {name: t.to(torch.int32) for name, t in (
        ("start", grid.start), ("count", grid.count), ("ring", grid.ring),
        ("item_cell", item_cell), ("item_first", item_first))}
    return KnnLaunch(grid, pts4, cells, k)


def knn_launch(prep: KnnLaunch) -> torch.Tensor:
    """Launch K2 on prepared inputs; (n,) float32 in the points' order."""
    n, c = len(prep.pts4), prep.cells
    out_sorted = torch.empty(n, dtype=torch.float32, device=prep.pts4.device)
    wide = None
    if prep.k > KNN_REGISTER_K:
        wide = torch.empty(n * (prep.k + 1), dtype=torch.float32, device=prep.pts4.device)
    lib = _library()
    with torch.cuda.device(prep.pts4.device):
        stream = torch.cuda.current_stream(prep.pts4.device).cuda_stream
        rc = lib.knn_mean_dist_launch(
            prep.pts4.data_ptr(), n, prep.grid.key.data_ptr(), c["start"].data_ptr(),
            c["count"].data_ptr(), c["ring"].data_ptr(), len(prep.grid.key),
            c["item_cell"].data_ptr(), c["item_first"].data_ptr(), len(c["item_cell"]),
            prep.grid.steps[0], prep.grid.steps[1], prep.k,
            None if wide is None else wide.data_ptr(), out_sorted.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"knn_mean_dist kernel launch failed (n={n}, k={prep.k}, "
                           f"{len(c['item_cell'])} blocks): CUDA error {rc}")
    counts["knn_mean_dist"].kernel += 1
    out = torch.empty_like(out_sorted)
    out[prep.grid.order] = out_sorted
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
    """K3's inputs on the card: the reference points sorted by cell (float4)
    with their original indices, the dense cell table, and the queries."""

    ref4: torch.Tensor         # (n, 4) float32, sorted by cell
    ref_id: torch.Tensor       # (n,) int32 original index of each
    cell_first: torch.Tensor   # (sx * sy * sz + 1,) int32 first sorted point of each cell
    span: Tuple[int, int, int]   # cells along x, y, z
    inv: np.float32            # 1 / cell
    origin: Tuple[float, float, float]   # the first cell's floor(p * inv)
    query4: torch.Tensor       # (m, 4) float32


def nearest_prepare(ref: torch.Tensor, query: torch.Tensor) -> NearestLaunch:
    """The glue of K3 for n >= 1 CUDA reference points: the grid, its cells
    floor(p * inv) with the product taken in float64, where it is exact, as
    the kernel takes it for the queries."""
    n = len(ref)
    inv = nn_grid_scalar(ref.min(0).values.cpu().numpy(), ref.max(0).values.cpu().numpy(), n)
    cells = torch.floor(ref.double() * float(inv))
    origin = cells.min(0).values
    rel = (cells - origin).long()
    span = tuple(int(v) + 1 for v in rel.max(0).values.cpu())
    total = span[0] * span[1] * span[2]
    if total > NN_MAX_CELLS:
        raise ValueError(f"nearest_index: a grid of {span} cells exceeds {NN_MAX_CELLS}")
    lin = (rel[:, 0] * span[1] + rel[:, 1]) * span[2] + rel[:, 2]
    order = torch.argsort(lin, stable=True)
    first = torch.zeros(total + 1, dtype=torch.int32, device=ref.device)
    first[1:] = torch.cumsum(torch.bincount(lin, minlength=total), 0)
    pads = []
    for pts in (ref[order], query):
        p4 = torch.zeros((len(pts), 4), dtype=torch.float32, device=pts.device)
        p4[:, :3] = pts
        pads.append(p4)
    return NearestLaunch(pads[0], order.to(torch.int32), first, span, inv,
                         tuple(float(c) for c in origin.cpu()), pads[1])


def nearest_launch(prep: NearestLaunch, pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 on prepared inputs (m >= 1); (m,) int64. `pairs`, a (1,)
    int64 CUDA tensor, gains the squared distances the search evaluated."""
    n, m = len(prep.ref4), len(prep.query4)
    out = torch.empty(m, dtype=torch.int64, device=prep.query4.device)
    lib = _library()
    with torch.cuda.device(prep.ref4.device):
        stream = torch.cuda.current_stream(prep.ref4.device).cuda_stream
        rc = lib.nearest_index_launch(
            prep.ref4.data_ptr(), prep.ref_id.data_ptr(), prep.cell_first.data_ptr(), n,
            *prep.span, float(prep.inv), *prep.origin, prep.query4.data_ptr(), m,
            out.data_ptr(), None if pairs is None else pairs.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nearest_index kernel launch failed (n={n}, m={m}, grid "
                           f"{prep.span}): CUDA error {rc}")
    counts["nearest_index"].kernel += 1
    return out


def nearest_index(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(m,) int64 index of the nearest of the (n, 3) float32 `ref` points for
    each of the (m, 3) float32 `query` points (n >= 1), the lowest index
    among equal squared distances: K3 on CUDA tensors, the plain version on
    CPU tensors."""
    _check_points(ref, "nearest_index")
    _check_points(query, "nearest_index")
    if ref.device != query.device:
        raise ValueError(f"nearest_index: ref on {ref.device}, query on {query.device}")
    if len(ref) == 0 and len(query):
        raise ValueError("nearest_index: no reference points")
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
            ctypes.c_void_p,     # points sorted by cell, (n, 4) float32
            ctypes.c_int,        # n
            ctypes.c_void_p,     # cell keys, (C,) int64 ascending
            ctypes.c_void_p,     # cell starts, (C,) int32
            ctypes.c_void_p,     # cell counts, (C,) int32
            ctypes.c_void_p,     # cell rings R, (C,) int32
            ctypes.c_int,        # C
            ctypes.c_void_p,     # the cell of each block, int32
            ctypes.c_void_p,     # the first point of the cell a block takes, int32
            ctypes.c_int,        # blocks
            ctypes.c_longlong,   # key step of one cell along x
            ctypes.c_longlong,   # key step along y
            ctypes.c_int,        # k
            ctypes.c_void_p,     # scratch, n * (k + 1) float32 where k > KNN_REGISTER_K
            ctypes.c_void_p,     # out, (n,) float32 in sorted order
            ctypes.c_void_p,     # stream
        ]
        lib.nearest_index_launch.restype = ctypes.c_int
        lib.nearest_index_launch.argtypes = [
            ctypes.c_void_p,     # ref sorted by cell, (n, 4) float32
            ctypes.c_void_p,     # their original indices, (n,) int32
            ctypes.c_void_p,     # cell table, (sx * sy * sz + 1,) int32
            ctypes.c_int,        # n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # sx, sy, sz
            ctypes.c_float,      # inv
            ctypes.c_double, ctypes.c_double, ctypes.c_double,   # the grid's origin cell
            ctypes.c_void_p,     # query, (m, 4) float32
            ctypes.c_int,        # m
            ctypes.c_void_p,     # out, (m,) int64
            ctypes.c_void_p,     # pairs evaluated, (1,) int64, or null
            ctypes.c_void_p,     # stream
        ]
        _lib = lib
    return _lib
