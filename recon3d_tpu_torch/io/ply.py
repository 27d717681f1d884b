"""PLY point-cloud I/O.

PyTorch port of recon3d_tpu/io/ply.py: `save_ply`, `load_ply` and
`save_cameras_ply`, copied (numpy only, with the optional native C++ ASCII
fast path of runtime/native.py). The mesh writer and reader wait for the
TSDF slice.
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

        if n and native_ply_write_ascii(path, points, colors):
            return
        with open(path, "a") as f:
            cols = np.concatenate([points.astype(np.float64), colors.astype(np.int64)], axis=1)
            lines = [
                "%.6f %.6f %.6f %d %d %d" % tuple(row) for row in cols
            ]
            f.write("\n".join(lines))
            if n:
                f.write("\n")


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
            if data is None:
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
