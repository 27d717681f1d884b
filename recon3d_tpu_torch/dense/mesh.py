"""Triangle-mesh extraction from a TSDF volume: marching tetrahedra.

Copy of recon3d_tpu/dense/mesh.py (host numpy) for the PyTorch port, over
the port's TSDFVolume (dense/tsdf.py), with the vertex colours from K3,
the exact nearest-neighbour kernel (kernels/pointcloud.py). Marching
tetrahedra instead of marching cubes: splitting each cube into 6 Kuhn
tetrahedra leaves only 16 sign cases with closed-form triangulations (1
or 2 triangles), with no 256-entry case table. Vectorized over an
active-cube prefilter (sign change and observed weight), so cost scales
with the surface, not the volume.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from recon3d_tpu_torch.dense.tsdf import TSDFVolume
from recon3d_tpu_torch.runtime.native import native_nearest_index

# Kuhn decomposition: 6 tetrahedra per cube, each walking (0,0,0) ->
# (1,1,1) one axis at a time (one tet per axis permutation). Shared faces
# between neighboring tets/cubes match up, so the extracted surface is
# crack-free.
_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _tet_corner_offsets() -> np.ndarray:
    """(6, 4, 3) voxel-corner offsets of the 6 tets of one cube."""
    tets = []
    for p in _PERMS:
        v = np.zeros((4, 3), np.int32)
        for k, axis in enumerate(p):
            v[k + 1] = v[k]
            v[k + 1, axis] += 1
        tets.append(v)
    return np.stack(tets)  # (6, 4, 3)


_TETS = _tet_corner_offsets()

# For the 2-inside/2-outside cases: the 6 unordered vertex pairs of a tet
# and, per pair, the quad of crossing edges in cyclic order.
_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def extract_mesh(
    vol: TSDFVolume,
    min_weight: float = 1.0,
    iso: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a fused TSDF.

    Returns (vertices (Nv, 3) float32 world coords, faces (Nf, 3) int32),
    faces oriented so normals point toward positive TSDF (empty space).
    """
    tsdf = np.asarray(vol.tsdf, np.float32)
    weight = np.asarray(vol.weight, np.float32)
    n = tsdf.shape[0]
    if n < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Active cubes: all 8 corners observed, and a sign change among them.
    obs = weight >= min_weight
    s = tsdf - iso
    neg = (s < 0) & obs
    pos = (s >= 0) & obs

    def _corner_all(a):
        return (
            a[:-1, :-1, :-1] & a[:-1, :-1, 1:] & a[:-1, 1:, :-1]
            & a[:-1, 1:, 1:] & a[1:, :-1, :-1] & a[1:, :-1, 1:]
            & a[1:, 1:, :-1] & a[1:, 1:, 1:]
        )

    def _corner_any(a):
        return (
            a[:-1, :-1, :-1] | a[:-1, :-1, 1:] | a[:-1, 1:, :-1]
            | a[:-1, 1:, 1:] | a[1:, :-1, :-1] | a[1:, :-1, 1:]
            | a[1:, 1:, :-1] | a[1:, 1:, 1:]
        )

    active = _corner_all(obs) & _corner_any(neg) & _corner_any(pos)
    cz, cy, cx = np.nonzero(active)
    if len(cz) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Tet corner grid indices: (A, 6, 4, 3) -> flattened (T, 4, 3).
    base = np.stack([cz, cy, cx], axis=-1)[:, None, None, :]  # (A,1,1,3) zyx
    off_zyx = _TETS[None, :, :, ::-1]  # offsets are (x,y,z) -> flip to zyx
    corn = base + off_zyx  # (A, 6, 4, 3)
    corn = corn.reshape(-1, 4, 3)
    vals = s[corn[..., 0], corn[..., 1], corn[..., 2]]  # (T, 4)

    # World coordinates of tet corners: grid index (z,y,x) -> world.
    xyz = corn[..., ::-1].astype(np.float32)  # (T, 4, 3) as (x, y, z)
    pts = vol.origin[None, None, :] + vol.voxel * xyz

    inside = vals < 0
    count = inside.sum(axis=1)

    tris = []  # list of (K, 3, 3) world-space triangles

    def _cross(pa, pb, sa, sb):
        # ALWAYS interpolate from the inside (negative) endpoint: crossings
        # on a grid edge shared between tets/cubes are then computed with
        # bitwise-identical arithmetic, so the weld below is exact.
        t = sa / (sa - sb)
        return pa + t[:, None] * (pb - pa)

    # -- 1 inside / 3 outside (and mirrored): one triangle per tet --------
    for lone_inside, cnt in ((True, 1), (False, 3)):
        m = count == cnt
        if not m.any():
            continue
        v, p = vals[m], pts[m]
        lone = np.argmax(inside[m] == lone_inside, axis=1)
        rows = np.arange(len(lone))
        others = np.stack(
            [np.where(lone <= k, k + 1, k) for k in range(3)], axis=1
        )  # (K, 3) the 3 non-lone corner slots
        sl = v[rows, lone]
        pl = p[rows, lone]
        if lone_inside:
            cr = [
                _cross(pl, p[rows, others[:, k]], sl, v[rows, others[:, k]])
                for k in range(3)
            ]
        else:  # lone vertex is outside: inside endpoints are the others
            cr = [
                _cross(p[rows, others[:, k]], pl, v[rows, others[:, k]], sl)
                for k in range(3)
            ]
        tris.append(np.stack(cr, axis=1))

    # -- 2 inside / 2 outside: two triangles per tet -----------------------
    m2 = count == 2
    if m2.any():
        v, p, ins = vals[m2], pts[m2], inside[m2]
        for (a, b) in _PAIRS:
            sel = ins[:, a] & ins[:, b]
            if not sel.any():
                continue
            out_pair = [k for k in range(4) if k not in (a, b)]
            c, d = out_pair
            vv, pp = v[sel], p[sel]
            e_ac = _cross(pp[:, a], pp[:, c], vv[:, a], vv[:, c])
            e_ad = _cross(pp[:, a], pp[:, d], vv[:, a], vv[:, d])
            e_bd = _cross(pp[:, b], pp[:, d], vv[:, b], vv[:, d])
            e_bc = _cross(pp[:, b], pp[:, c], vv[:, b], vv[:, c])
            tris.append(np.stack([e_ac, e_ad, e_bd], axis=1))
            tris.append(np.stack([e_ac, e_bd, e_bc], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    T = np.concatenate(tris, axis=0)  # (Nt, 3, 3)

    # Drop degenerate slivers (zero-crossing hit a corner exactly).
    e1 = T[:, 1] - T[:, 0]
    e2 = T[:, 2] - T[:, 0]
    nrm = np.cross(e1, e2)
    area2 = np.linalg.norm(nrm, axis=1)
    keep = area2 > 1e-12 * vol.voxel * vol.voxel
    T, nrm = T[keep], nrm[keep]

    # Orient every triangle so its normal points toward positive TSDF:
    # compare with a nearest-voxel central-difference gradient at the
    # centroid (coarse but adequate — a flip needs the gradient WRONG by
    # >90 deg, which a one-voxel offset doesn't produce on trunc>=3vx SDFs).
    cent = T.mean(axis=1)
    g = _sdf_gradient(s, vol, cent)
    flip = np.einsum("ij,ij->i", nrm, g) < 0
    T[flip] = T[flip][:, ::-1]

    # Weld duplicate vertices (shared tet/cube edges produce identical
    # crossings): quantize fine relative to the voxel size.
    q = np.round(T.reshape(-1, 3) / (vol.voxel * 1e-4)).astype(np.int64)
    uq, inv = np.unique(q, axis=0, return_inverse=True)
    verts = np.zeros((len(uq), 3), np.float64)
    np.add.at(verts, inv, T.reshape(-1, 3))
    cnt = np.bincount(inv, minlength=len(uq)).astype(np.float64)
    verts = (verts / cnt[:, None]).astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop faces that collapsed in the weld
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


def _sdf_gradient(s: np.ndarray, vol: TSDFVolume, world: np.ndarray) -> np.ndarray:
    """Central-difference SDF gradient at world points (nearest voxel)."""
    n = s.shape[0]
    gidx = (world - vol.origin[None, :]) / vol.voxel  # (x, y, z)
    ix = np.clip(np.round(gidx[:, 0]).astype(np.int64), 1, n - 2)
    iy = np.clip(np.round(gidx[:, 1]).astype(np.int64), 1, n - 2)
    iz = np.clip(np.round(gidx[:, 2]).astype(np.int64), 1, n - 2)
    gx = s[iz, iy, ix + 1] - s[iz, iy, ix - 1]
    gy = s[iz, iy + 1, ix] - s[iz, iy - 1, ix]
    gz = s[iz + 1, iy, ix] - s[iz - 1, iy, ix]
    return np.stack([gx, gy, gz], axis=-1)


def mesh_vertex_colors(
    verts: np.ndarray,
    points: np.ndarray,
    colors: np.ndarray,
    device="cuda",
) -> np.ndarray:
    """Color mesh vertices from the nearest fused cloud point: exact
    nearest neighbours through K3 (kernels/pointcloud.py; both counts reach
    millions on real scenes), the lowest index among equal distances."""
    if len(points) == 0 or len(verts) == 0:
        return np.full((len(verts), 3), 180, np.uint8)
    return colors[native_nearest_index(verts, points, device=device)]
