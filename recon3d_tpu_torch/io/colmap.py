"""COLMAP sparse-model text format: writer and reader.

PyTorch port: a verbatim copy of recon3d_tpu/io/colmap.py (numpy only).

Interop the reference does not have: the reference only shells out to the
COLMAP binary (src/tools/run_colmap.py) and ships pre-built COLMAP PLYs
(data/samples/*/colmap_reconstruction); it cannot exchange its own SfM
state with the COLMAP ecosystem. This module writes the reconstruction as
a standard COLMAP text model (cameras.txt / images.txt / points3D.txt), so
downstream tools (COLMAP GUI/dense, nerfstudio, gsplat, Metashape
importers) consume our output directly — and reads such models back, so an
existing COLMAP sparse reconstruction can feed this framework's TPU dense
stages (`--from-colmap`).

Format per COLMAP's documented sparse text model:
  cameras.txt:  CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]
  images.txt:   IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME
                then one line: X Y POINT3D_ID triplets (-1 = untracked)
  points3D.txt: POINT3D_ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)*
Conventions match ours: X_cam = R @ X_world + t, quaternion scalar-first
(qw qx qy qz) for R. Host-side I/O is plain numpy (no device work).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# -- rotation <-> quaternion (scalar-first, numpy, host-side) ----------------


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> (qw, qx, qy, qz), Shepperd's method (stable for
    every trace sign), normalized, qw >= 0."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([
            0.25 * s,
            (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s,
        ])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(qw, qx, qy, qz) -> (3,3) rotation."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


# -- model containers ---------------------------------------------------------


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-dependent

    def K(self) -> np.ndarray:
        """Intrinsics in the framework's integer-pixel-center convention
        (COLMAP puts the top-left pixel center at (0.5, 0.5); ours is at
        (0, 0), so cx/cy shift by -0.5)."""
        p = self.params
        if self.model in ("PINHOLE", "OPENCV", "FULL_OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        elif self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            # Fisheye models carry k1..k4 in a NON-OpenCV-pinhole
            # convention that dist() cannot represent; refuse rather than
            # silently treating heavily-distorted pixels as pinhole.
            raise ValueError(f"unsupported COLMAP camera model {self.model}")
        return np.array(
            [[fx, 0, cx - 0.5], [0, fy, cy - 0.5], [0, 0, 1]], np.float32
        )

    def dist(self) -> np.ndarray:
        """OpenCV-convention [k1, k2, p1, p2, k3] (zeros where absent)."""
        p = self.params
        d = np.zeros(5, np.float32)
        if self.model == "SIMPLE_RADIAL":
            d[0] = p[3]
        elif self.model == "RADIAL":
            d[0], d[1] = p[3], p[4]
        elif self.model == "OPENCV":
            d[:4] = p[4:8]
        elif self.model == "FULL_OPENCV":
            d[:4] = p[4:8]
            d[4] = p[8]
        return d


@dataclass
class ColmapImage:
    image_id: int
    q: np.ndarray            # (4,) qw qx qy qz
    t: np.ndarray            # (3,)
    camera_id: int
    name: str
    xys: np.ndarray          # (N, 2) 2D points
    point3d_ids: np.ndarray  # (N,) int64, -1 = untracked

    def R(self) -> np.ndarray:
        return quat_to_rotmat(self.q)


@dataclass
class ColmapModel:
    cameras: Dict[int, ColmapCamera] = field(default_factory=dict)
    images: Dict[int, ColmapImage] = field(default_factory=dict)
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    colors: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.uint8))
    errors: np.ndarray = field(default_factory=lambda: np.zeros(0))
    point_ids: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    tracks: List[List[Tuple[int, int]]] = field(default_factory=list)

    def poses(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """{image_id: (R, t)} world-to-camera, our pipeline's convention."""
        return {
            i: (im.R().astype(np.float32), im.t.astype(np.float32))
            for i, im in self.images.items()
        }


# -- writer -------------------------------------------------------------------


def save_colmap_text(
    out_dir: str,
    K: np.ndarray,
    image_size: Tuple[int, int],
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    points: np.ndarray,
    colors: Optional[np.ndarray],
    observations: Optional[Sequence[Sequence[Tuple[int, int]]]] = None,
    kp_xy: Optional[Sequence[np.ndarray]] = None,
    names: Optional[Sequence[str]] = None,
    dist: Optional[np.ndarray] = None,
) -> None:
    """Write a COLMAP sparse text model.

    Args:
      out_dir: directory for cameras.txt / images.txt / points3D.txt.
      K: shared (3,3) intrinsics; image_size: (height, width).
      poses: {cam_index: (R, t)} world-to-camera.
      points: (P, 3); colors: (P, 3) uint8 or None.
      observations: observations[p] = [(cam_index, kp_index), ...] tracks
        (the SfM pipeline's table); kp_xy[cam] = (N, 2) keypoint pixels.
        When omitted, images carry no 2D points and points no tracks.
      names: image file names keyed by cam_index.
      dist: optional [k1,k2,p1,p2,k3] -> OPENCV camera model.
    """
    os.makedirs(out_dir, exist_ok=True)
    H, W = int(image_size[0]), int(image_size[1])
    K = np.asarray(K, np.float64)
    points = np.asarray(points, np.float64).reshape(-1, 3)
    nP = len(points)
    if colors is None:
        colors = np.full((nP, 3), 128, np.uint8)
    colors = np.asarray(colors).reshape(-1, 3).astype(np.uint8)

    cam_ids = sorted(poses.keys())
    image_id = {c: i + 1 for i, c in enumerate(cam_ids)}  # COLMAP ids 1-based

    use_dist = dist is not None and np.any(np.abs(np.asarray(dist)) > 1e-12)
    # COLMAP's pixel convention puts the top-left pixel CENTER at (0.5, 0.5);
    # the framework's is (0, 0) — every written pixel coordinate (cx/cy and
    # keypoints) shifts by +0.5, and the reader shifts back.
    cx_w, cy_w = K[0, 2] + 0.5, K[1, 2] + 0.5
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        if use_dist:
            d = np.asarray(dist, np.float64).reshape(-1)
            if abs(d[4]) > 1e-12:
                # OPENCV has no k3 slot; FULL_OPENCV is
                # fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6
                f.write(
                    f"1 FULL_OPENCV {W} {H} {K[0,0]:.10g} {K[1,1]:.10g} "
                    f"{cx_w:.10g} {cy_w:.10g} "
                    f"{d[0]:.10g} {d[1]:.10g} {d[2]:.10g} {d[3]:.10g} "
                    f"{d[4]:.10g} 0 0 0\n"
                )
            else:
                f.write(
                    f"1 OPENCV {W} {H} {K[0,0]:.10g} {K[1,1]:.10g} "
                    f"{cx_w:.10g} {cy_w:.10g} "
                    f"{d[0]:.10g} {d[1]:.10g} {d[2]:.10g} {d[3]:.10g}\n"
                )
        else:
            f.write(
                f"1 PINHOLE {W} {H} {K[0,0]:.10g} {K[1,1]:.10g} "
                f"{cx_w:.10g} {cy_w:.10g}\n"
            )

    # Per-image 2D point lists: only keypoints that track a 3D point (valid
    # COLMAP; keeps files proportional to the model, not the detector).
    img_xys: Dict[int, List[Tuple[float, float, int]]] = {c: [] for c in cam_ids}
    # (pid -> [(image_id, point2d_idx)]) track table for points3D.txt
    tracks: List[List[Tuple[int, int]]] = [[] for _ in range(nP)]
    flat_cam, flat_pid, flat_xy = [], [], []  # one obs per row, for errors
    if observations is not None and kp_xy is not None:
        for pid, obs in enumerate(observations):
            if pid >= nP:
                break
            for cam, kp in obs:
                if cam not in img_xys:
                    continue
                xy = kp_xy[cam][kp]
                idx2d = len(img_xys[cam])
                img_xys[cam].append((float(xy[0]), float(xy[1]), pid + 1))
                tracks[pid].append((image_id[cam], idx2d))
                flat_cam.append(image_id[cam] - 1)
                flat_pid.append(pid)
                flat_xy.append(xy)

    # Mean reprojection error per point: one vectorized pass over the flat
    # observation table (host numpy; exact).
    errors = np.full(nP, -1.0)
    if flat_pid:
        Rs = np.stack([np.asarray(poses[c][0]) for c in cam_ids]).astype(np.float64)
        ts = np.stack([np.asarray(poses[c][1]).reshape(3) for c in cam_ids]).astype(np.float64)
        fc = np.asarray(flat_cam)
        fp = np.asarray(flat_pid)
        fxy = np.asarray(flat_xy, np.float64).reshape(-1, 2)
        Xc = np.einsum("oij,oj->oi", Rs[fc], points[fp]) + ts[fc]
        z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        uv = (Xc[:, :2] / z[:, None]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        e = np.linalg.norm(uv - fxy, axis=1)
        sums = np.zeros(nP)
        cnts = np.zeros(nP)
        np.add.at(sums, fp, e)
        np.add.at(cnts, fp, 1.0)
        errors = np.where(cnts > 0, sums / np.maximum(cnts, 1), -1.0)

    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for c in cam_ids:
            R, t = poses[c]
            q = rotmat_to_quat(np.asarray(R))
            t = np.asarray(t, np.float64).reshape(3)
            name = names[c] if names is not None and c < len(names) else f"image_{c:05d}.png"
            f.write(
                f"{image_id[c]} {q[0]:.12g} {q[1]:.12g} {q[2]:.12g} "
                f"{q[3]:.12g} {t[0]:.12g} {t[1]:.12g} {t[2]:.12g} 1 {name}\n"
            )
            f.write(" ".join(
                f"{x + 0.5:.7g} {y + 0.5:.7g} {pid3}"
                for x, y, pid3 in img_xys[c]
            ) + "\n")

    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid in range(nP):
            x, y, z = points[pid]
            r, g, b = colors[pid] if pid < len(colors) else (128, 128, 128)
            tr = " ".join(f"{im} {i2}" for im, i2 in tracks[pid])
            f.write(
                f"{pid + 1} {x:.12g} {y:.12g} {z:.12g} {int(r)} {int(g)} "
                f"{int(b)} {errors[pid]:.6g}{' ' + tr if tr else ''}\n"
            )


# -- reader -------------------------------------------------------------------


def load_colmap_text(model_dir: str) -> ColmapModel:
    """Read a COLMAP sparse text model directory (cameras/images/points3D)."""
    model = ColmapModel()

    with open(os.path.join(model_dir, "cameras.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            model.cameras[int(parts[0])] = ColmapCamera(
                camera_id=int(parts[0]),
                model=parts[1],
                width=int(parts[2]),
                height=int(parts[3]),
                params=np.array([float(v) for v in parts[4:]]),
            )

    with open(os.path.join(model_dir, "images.txt")) as f:
        lines = [
            ln.rstrip("\n") for ln in f
            if not ln.lstrip().startswith("#")
        ]
    # Two lines per record; the POINTS2D line may be EMPTY (an image with
    # no tracked keypoints), so blank lines are only skipped when a header
    # is expected.
    records = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        records.append((lines[i], lines[i + 1] if i + 1 < len(lines) else ""))
        i += 2
    for hdr, pts in records:
        parts = hdr.split()
        image_id = int(parts[0])
        vals = pts.split()
        # -0.5: COLMAP half-pixel-center convention -> ours (see writer)
        xys = np.array(
            [[float(vals[i]) - 0.5, float(vals[i + 1]) - 0.5]
             for i in range(0, len(vals), 3)], np.float64
        ).reshape(-1, 2)
        p3 = np.array(
            [int(vals[i + 2]) for i in range(0, len(vals), 3)], np.int64
        )
        model.images[image_id] = ColmapImage(
            image_id=image_id,
            q=np.array([float(v) for v in parts[1:5]]),
            t=np.array([float(v) for v in parts[5:8]]),
            camera_id=int(parts[8]),
            name=" ".join(parts[9:]),
            xys=xys,
            point3d_ids=p3,
        )

    pts, cols, errs, pids, tracks = [], [], [], [], []
    with open(os.path.join(model_dir, "points3D.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pids.append(int(parts[0]))
            pts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            cols.append([int(parts[4]), int(parts[5]), int(parts[6])])
            errs.append(float(parts[7]))
            tr = parts[8:]
            tracks.append(
                [(int(tr[i]), int(tr[i + 1])) for i in range(0, len(tr), 2)]
            )
    model.points = np.asarray(pts, np.float64).reshape(-1, 3)
    model.colors = np.asarray(cols, np.uint8).reshape(-1, 3)
    model.errors = np.asarray(errs)
    model.point_ids = np.asarray(pids, np.int64)
    model.tracks = tracks
    return model
