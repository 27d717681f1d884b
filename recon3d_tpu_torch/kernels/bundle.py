"""Bundle adjustment's Schur-reduced LM step as hand-written CUDA kernels
(csrc/bundle.cu), and the buffers of one step on the card.

No Pallas kernel stands behind them: the JAX package's bundle adjustment
(recon3d_tpu/sfm/bundle.py) is plain jnp. The plain version is the einsum
and cumsum code of sfm/bundle.py::_lm_step_plain, which a table on the CPU
takes; a table on the card takes these kernels (sfm/bundle.py::
_lm_step_kernels drives them) or raises. csrc/bundle.cu says what each
kernel computes, what bounds it and why it walks segments rather than
scanning the table.

`Step` allocates one LM step's buffers (only the rows inside a segment are
ever written or read) and launches each kernel on PyTorch's current stream;
nothing here synchronises. `counts` records the kernels enqueued. The kernels are compiled on first use with
nvcc into recon3d_tpu_torch/_build (a plain C entry point, loaded with
ctypes), never when this module is imported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import torch

from recon3d_tpu_torch.kernels.build import build_library
from recon3d_tpu_torch.kernels.warp import NVCC_FLAGS, nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bundle.cu"
# Floats a row or a segment keeps (csrc/bundle.cu: ROW_PM ... CSUM).
ROW_PM = 24   # point-major row: Jc, Jp, camera, weight, r, point
ROW_CM = 20   # camera-major row: Jc, Jp, point
PSUM = 10     # a point's sums: Jp^T Jp, Jp^T r, r.r
PBLK = 12     # a point's blocks: Cinv, g_p, w_p
CSUM = 40     # a camera's sums: g, diag, S (upper triangle), E w_p


@dataclass
class Counts:
    """Kernels enqueued since the last reset."""

    kernel: int = 0

    def reset(self) -> None:
        self.kernel = 0


counts = Counts()
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Each launcher's arguments before the stream (csrc/bundle.cu, extern "C").
_SIGNATURES = {
    "ba_linearize_launch": [_P] * 9 + [_I, _F, _P, _P],
    "ba_point_setup_launch": [_P, _P, _I, _I, _P],
    "ba_cam_setup_launch": [_P] * 5 + [_I, _P, _P],
    "ba_cg_init_launch": [_P, _P, _P, _I, _I] + [_P] * 7,
    "ba_point_pass_launch": [_P] * 4 + [_I, _P],
    "ba_cam_pass_launch": [_P] * 6 + [_I, _P],
    "ba_cg_update_launch": [_P, _P, _P, _I] + [_P] * 6,
    "ba_point_update_launch": [_P, _P, _I, _P],
    "ba_cost_launch": [_P] * 9 + [_I, _P],
    "ba_half_sum_launch": [_P, _I, _P],
}


def build() -> Tuple[Path, float, str]:
    """Compile csrc/bundle.cu into a shared library unless an identical
    build exists. Returns (library path, seconds spent compiling, nvcc's
    log)."""
    return build_library(SOURCE, "bundle", nvcc(), NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args + [_P]
        _lib = lib
    return _lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_table(data) -> None:
    """Raise unless `data` (sfm/bundle.py::BAData) is a table the kernels
    take: float32 and int64 tensors, contiguous, on one device, with the
    shapes BAData documents. The kernels trust its contents (indices in
    range, each camera segment's rows inside point segments), as
    sfm/bundle.py::_obs_table and _table_rows build them."""
    C, P, O = data.R0.shape[0], data.X0.shape[0], data.obs_cam.shape[0]
    shapes = {
        "K": (3, 3), "R0": (C, 3, 3), "t0": (C, 3), "X0": (P, 3), "obs_xy": (O, 2),
        "obs_w": (O,), "obs_cam": (O,), "obs_pt": (O,), "pt_start": (P,), "pt_end": (P,),
        "cam_perm": (O,), "cam_start": (C,), "cam_end": (C,),
    }
    ints = ("obs_cam", "obs_pt", "pt_start", "pt_end", "cam_perm", "cam_start", "cam_end")
    for name, shape in shapes.items():
        t = getattr(data, name)
        want = torch.int64 if name in ints else torch.float32
        if t.dtype != want or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"bundle kernels: {name} must be a contiguous {want} tensor of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != data.X0.device:
            raise ValueError(f"bundle kernels: {name} on {t.device}, the table on "
                             f"{data.X0.device}")


class Step:
    """One LM step's buffers on the table's device, and its launches.

    Vectors of the CG on the cameras are (C, 6): lam, x (the camera step),
    r, z, p, Ap and y (cam_pass's sums); M (C, 36) the preconditioner's
    blocks; scal holds cost0, rz and cost1. Per point: psum (P, PSUM), pblk
    (P, PBLK), s (P, 4) (a point_pass's sums), dX (P, 3) the point step and
    rr (P,) the candidate's squared residuals. psum, csum, s, y and rr are
    the partial sums that a mesh adds over its ranks."""

    def __init__(self, data, damping: torch.Tensor, delta: float, motion_only: bool):
        check_table(data)
        dev = data.X0.device
        if damping.dtype != torch.float32 or damping.numel() != 1 or damping.device != dev:
            raise ValueError("bundle kernels: damping must be one float32 on the table's device")
        self.lib = _library()
        self.stream = _stream(dev)
        self.data, self.damping = data, damping.contiguous()
        self.delta, self.motion_only = float(delta), int(bool(motion_only))
        C, P, O = data.R0.shape[0], data.X0.shape[0], data.obs_cam.shape[0]
        self.C, self.P = C, P

        def buf(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        self.rows, self.rows_cm = buf(O, ROW_PM), buf(O, ROW_CM)
        self.psum, self.pblk, self.s = buf(P, PSUM), buf(P, PBLK), buf(P, 4)
        self.dX, self.rr = buf(P, 3), buf(P)
        self.csum, self.M = buf(C, CSUM), buf(C, 36)
        self.lam, self.x, self.r, self.z, self.p, self.Ap, self.y = (buf(C, 6) for _ in range(7))
        self.scal = buf(3)

    def _launch(self, name: str, grid: int, *args) -> None:
        """Enqueue launcher `name` over `grid` points or cameras; an empty
        grid enqueues nothing and counts nothing."""
        if grid <= 0:
            return
        rc = getattr(self.lib, name)(*args, self.stream)
        if rc != 0:
            raise RuntimeError(f"bundle kernel {name} failed: CUDA error {rc}")
        counts.kernel += 1

    def linearize(self) -> None:
        d = self.data
        self._launch("ba_linearize_launch", self.P, d.K.data_ptr(), d.R0.data_ptr(),
                     d.t0.data_ptr(), d.X0.data_ptr(), d.obs_cam.data_ptr(),
                     d.obs_xy.data_ptr(), d.obs_w.data_ptr(), d.pt_start.data_ptr(),
                     d.pt_end.data_ptr(), self.P, self.delta, self.rows.data_ptr(),
                     self.psum.data_ptr())

    def point_setup(self) -> None:
        self._launch("ba_point_setup_launch", self.P, self.psum.data_ptr(),
                     self.damping.data_ptr(), self.P, self.motion_only, self.pblk.data_ptr())

    def cam_setup(self) -> None:
        d = self.data
        self._launch("ba_cam_setup_launch", self.C, self.rows.data_ptr(), d.cam_perm.data_ptr(),
                     d.cam_start.data_ptr(), d.cam_end.data_ptr(), self.pblk.data_ptr(), self.C,
                     self.rows_cm.data_ptr(), self.csum.data_ptr())

    def cg_init(self) -> None:
        self._launch("ba_cg_init_launch", 1, self.csum.data_ptr(), self.psum.data_ptr(),
                     self.damping.data_ptr(), self.C, self.P, self.M.data_ptr(),
                     self.lam.data_ptr(), self.x.data_ptr(), self.r.data_ptr(),
                     self.z.data_ptr(), self.p.data_ptr(), self.scal.data_ptr())

    def point_pass(self, v: torch.Tensor) -> None:
        """s = per point, the sum of Jp^T (Jc v_cam) (v: p or x)."""
        d = self.data
        self._launch("ba_point_pass_launch", self.P, self.rows.data_ptr(),
                     d.pt_start.data_ptr(), d.pt_end.data_ptr(), v.data_ptr(), self.P,
                     self.s.data_ptr())

    def cam_pass(self) -> None:
        d = self.data
        self._launch("ba_cam_pass_launch", self.C, self.rows_cm.data_ptr(),
                     d.cam_start.data_ptr(), d.cam_end.data_ptr(), self.pblk.data_ptr(),
                     self.s.data_ptr(), self.p.data_ptr(), self.C, self.y.data_ptr())

    def cg_update(self) -> None:
        self._launch("ba_cg_update_launch", 1, self.y.data_ptr(), self.M.data_ptr(),
                     self.lam.data_ptr(), self.C, self.x.data_ptr(), self.r.data_ptr(),
                     self.z.data_ptr(), self.p.data_ptr(), self.Ap.data_ptr(),
                     self.scal.data_ptr())

    def point_update(self) -> None:
        self._launch("ba_point_update_launch", self.P, self.pblk.data_ptr(), self.s.data_ptr(),
                     self.P, self.dX.data_ptr())

    def cost(self, R: torch.Tensor, t: torch.Tensor) -> None:
        """rr = per point, the candidate's squared weighted residuals at
        cameras (R, t) and points X0 + dX."""
        d = self.data
        self.R, self.t = R, t = R.contiguous(), t.contiguous()   # held while the kernel reads them
        self._launch("ba_cost_launch", self.P, d.K.data_ptr(), R.data_ptr(), t.data_ptr(),
                     d.X0.data_ptr(), self.dX.data_ptr(), self.rows.data_ptr(),
                     d.obs_xy.data_ptr(), d.pt_start.data_ptr(), d.pt_end.data_ptr(), self.P,
                     self.rr.data_ptr())

    def half_sum(self) -> None:
        """cost1 = 0.5 sum rr."""
        self._launch("ba_half_sum_launch", 1, self.rr.data_ptr(), self.P,
                     self.scal[2:].data_ptr())
