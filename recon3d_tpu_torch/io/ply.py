"""PLY point-cloud I/O.

PyTorch port of recon3d_tpu/io/ply.py: `save_ply`, `load_ply` and
`save_cameras_ply`, and the triangle-mesh writer and reader of the TSDF
stage (`save_mesh_ply`, `load_mesh_ply`), copied (numpy, with the ASCII
vertex rows written and parsed by the port's own host C++ library,
runtime/native.py, built at first use with g++).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def save_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    binary: bool = False,
) -> None:
    """Write xyz (+rgb uchar) PLY. ASCII by default (reference utils.py:8-37);
    binary little-endian available for large dense clouds."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    if colors is None:
        colors = np.full((n, 3), 200, dtype=np.uint8)
    else:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {n}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar red\n"
        "property uchar green\n"
        "property uchar blue\n"
        "end_header\n"
    )
    if binary:
        rec = np.empty(
            n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("r", "u1"), ("g", "u1"), ("b", "u1")]
        )
        rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
        rec["r"], rec["g"], rec["b"] = colors[:, 0], colors[:, 1], colors[:, 2]
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            rec.tofile(f)
    else:
        with open(path, "w") as f:
            f.write(header)
        from recon3d_tpu_torch.runtime.native import native_ply_write_ascii

        if n:
            native_ply_write_ascii(path, points, colors)


def save_cameras_ply(path: str, poses, scale: float = 0.5) -> None:
    """Camera visualization PLY: red center + green forward point per camera
    (reference utils.py:40-69). `poses` is a dict {idx: CameraPose} or a
    batched CameraPose (recon3d_tpu_torch.camera)."""
    if isinstance(poses, dict):
        centers = np.stack([np.asarray(p.center) for p in poses.values()])
        forwards = np.stack([np.asarray(p.look_at()) for p in poses.values()])
    else:
        centers = np.asarray(poses.center)
        forwards = np.asarray(poses.look_at())
    pts = np.concatenate([centers, centers + scale * forwards], axis=0)
    n = centers.shape[0]
    colors = np.concatenate(
        [
            np.tile([255, 0, 0], (n, 1)),
            np.tile([0, 255, 0], (n, 1)),
        ]
    ).astype(np.uint8)
    save_ply(path, pts, colors)


def _parse_header(f) -> Tuple[str, int, list, int]:
    """Returns (format, vertex_count, [(name, np_dtype_str)], header_bytes)."""
    magic = f.readline()
    if magic.strip() not in (b"ply", "ply"):
        raise ValueError("not a PLY file")
    fmt = None
    n_vertices = 0
    props = []
    in_vertex_element = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        if isinstance(line, bytes):
            line = line.decode("ascii", errors="replace")
        tokens = line.strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex_element = tokens[1] == "vertex"
            if in_vertex_element:
                n_vertices = int(tokens[2])
        elif tokens[0] == "property" and in_vertex_element:
            if tokens[1] == "list":
                raise ValueError("list properties on vertex element unsupported")
            props.append((tokens[-1], _PLY_TO_NP[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    return fmt, n_vertices, props, f.tell()


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PLY file -> (points (N,3) float32, colors (N,3) uint8 or None).

    Handles ASCII and binary little/big endian with arbitrary vertex property
    layouts, filtering non-finite rows (reference viewer.py:35-160).
    """
    with open(path, "rb") as f:
        fmt, n, props, offset = _parse_header(f)
        names = [p[0] for p in props]
        if fmt == "ascii":
            from recon3d_tpu_torch.runtime.native import native_ply_parse_ascii

            data = native_ply_parse_ascii(path, offset, n, len(props))
            if data is None:  # fewer well-formed rows than the header says
                data = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            if data.size == 0:
                return np.zeros((0, 3), np.float32), None
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            dtype = np.dtype([(name, endian + t) for name, t in props])
            raw = np.fromfile(f, dtype=dtype, count=n)
            rec = {name: raw[name] for name in names}

    for axis in ("x", "y", "z"):
        if axis not in rec:
            raise ValueError(f"PLY missing vertex property '{axis}'")
    pts = np.stack(
        [rec["x"], rec["y"], rec["z"]], axis=1
    ).astype(np.float32)

    colors = None
    color_keys = None
    if all(k in rec for k in ("red", "green", "blue")):
        color_keys = ("red", "green", "blue")
    elif all(k in rec for k in ("r", "g", "b")):
        color_keys = ("r", "g", "b")
    if color_keys:
        c = np.stack([rec[k] for k in color_keys], axis=1)
        if c.dtype.kind == "f" and c.size and c.max() <= 1.0:
            c = c * 255.0
        colors = np.clip(c, 0, 255).astype(np.uint8)

    finite = np.isfinite(pts).all(axis=1)
    if not finite.all():
        pts = pts[finite]
        if colors is not None:
            colors = colors[finite]
    return pts, colors


def compute_scene_bounds(points: np.ndarray):
    """(min, max, center, diagonal) of a point cloud (reference utils.py:72-86)."""
    pts = np.asarray(points).reshape(-1, 3)
    if pts.shape[0] == 0:
        z = np.zeros(3, np.float32)
        return z, z, z, 0.0
    mn = pts.min(axis=0)
    mx = pts.max(axis=0)
    center = (mn + mx) / 2
    diag = float(np.linalg.norm(mx - mn))
    return mn, mx, center, diag


def save_mesh_ply(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write a triangle mesh PLY (vertex xyz [+rgb uchar], uchar-counted
    int32 face indices). Mesh output is a framework capability beyond the
    reference (point-cloud PLYs only, utils.py:8-37)."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    nv, nf = len(vertices), len(faces)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fmt = "binary_little_endian" if binary else "ascii"
    color_props = (
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        if has_color else ""
    )
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {nv}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        f"{color_props}"
        f"element face {nf}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    if binary:
        vdt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if has_color:
            vdt += [("r", "u1"), ("g", "u1"), ("b", "u1")]
        vrec = np.empty(nv, dtype=vdt)
        vrec["x"], vrec["y"], vrec["z"] = (
            vertices[:, 0], vertices[:, 1], vertices[:, 2]
        )
        if has_color:
            vrec["r"], vrec["g"], vrec["b"] = (
                colors[:, 0], colors[:, 1], colors[:, 2]
            )
        frec = np.empty(nf, dtype=[("n", "u1"), ("i", "<i4", (3,))])
        frec["n"] = 3
        frec["i"] = faces
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(vrec.tobytes())
            f.write(frec.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for i in range(nv):
                row = f"{vertices[i,0]:.6g} {vertices[i,1]:.6g} {vertices[i,2]:.6g}"
                if has_color:
                    row += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
                f.write(row + "\n")
            for i in range(nf):
                f.write(f"3 {faces[i,0]} {faces[i,1]} {faces[i,2]}\n")


def load_mesh_ply(path: str):
    """Read a triangle-mesh PLY written by save_mesh_ply (ascii or binary
    little-endian, uchar-counted int32 triangles).
    Returns (vertices (V,3) f32, faces (F,3) i32, colors (V,3) u8 or None)."""
    with open(path, "rb") as f:
        fmt, counts, layouts, header_len = _parse_mesh_header(f)
    nv, nf = counts
    vprops = layouts
    with open(path, "rb") as f:
        f.seek(header_len)
        if fmt == "ascii":
            text = f.read().decode("ascii").strip().split("\n")
            vrows = [text[i].split() for i in range(nv)]
            frows = [text[nv + i].split() for i in range(nf)]
            arr = np.asarray(vrows, np.float64)
            verts = arr[:, :3].astype(np.float32)
            cols = (
                arr[:, 3:6].astype(np.uint8) if arr.shape[1] >= 6 else None
            )
            faces = np.asarray([r[1:4] for r in frows], np.int32)
            return verts, faces, cols
        vdt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if vprops >= 6:
            vdt += [("r", "u1"), ("g", "u1"), ("b", "u1")]
        vrec = np.frombuffer(f.read(np.dtype(vdt).itemsize * nv), dtype=vdt)
        verts = np.stack([vrec["x"], vrec["y"], vrec["z"]], axis=1)
        cols = (
            np.stack([vrec["r"], vrec["g"], vrec["b"]], axis=1)
            if vprops >= 6 else None
        )
        fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
        frec = np.frombuffer(f.read(fdt.itemsize * nf), dtype=fdt)
        return verts.astype(np.float32), frec["i"].astype(np.int32), cols


def _parse_mesh_header(f):
    """Minimal header parse for save_mesh_ply's own layouts."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    nv = nf = 0
    vprops = 0
    in_vertex = False
    pos = 0
    f.seek(0)
    while True:
        line = f.readline()
        pos = f.tell()
        t = line.strip().split()
        if not t:
            continue
        if t[0] == b"format":
            fmt = t[1].decode()
        elif t[0] == b"element":
            in_vertex = t[1] == b"vertex"
            if in_vertex:
                nv = int(t[2])
            elif t[1] == b"face":
                nf = int(t[2])
        elif t[0] == b"property" and in_vertex and t[1] != b"list":
            vprops += 1
        elif t[0] == b"end_header":
            return fmt, (nv, nf), vprops, pos
