"""The PyTorch port stands alone: it never imports jax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import numpy as np
import torch
import recon3d_tpu_torch.cli
import recon3d_tpu_torch.convert
import recon3d_tpu_torch.io.dataset
from recon3d_tpu_torch.dense.patchmatch import patchmatch_depth
g = np.random.default_rng(0).random((5, 32, 40)).astype(np.float32)
K = torch.tensor([[40.0, 0, 19.5], [0, 40.0, 15.5], [0, 0, 1]])
R = torch.eye(3).repeat(4, 1, 1)
t = torch.tensor([[0.1 * j, 0.0, 0.0] for j in range(4)])
out = patchmatch_depth(torch.from_numpy(g[0]), torch.from_numpy(g[1:]), K, torch.eye(3),
                       torch.zeros(3), R, t, torch.tensor([1.0, 5.0]),
                       generator=torch.Generator().manual_seed(0),
                       num_iterations=1, patch=5)
assert out.depth.shape == (32, 40) and torch.isfinite(out.depth).all()
import recon3d_tpu_torch.sfm.pipeline
from recon3d_tpu_torch.features.frontend import FeatureExtractor
feats = FeatureExtractor(device="cpu").extract_batch(g[:2, :, :].repeat(2, axis=1).repeat(2, axis=2))
assert feats.desc.shape[0] == 2 and feats.desc.shape[2] == 128
assert torch.isfinite(feats.desc).all() and feats.valid.dtype == torch.bool
from recon3d_tpu_torch.dense.mesh import extract_mesh
from recon3d_tpu_torch.dense.tsdf import fuse_tsdf
d = np.full((2, 24, 32), 2.0, np.float32)
Kn = np.float32([[30, 0, 15.5], [0, 30, 11.5], [0, 0, 1]])
vol = fuse_tsdf(d, None, Kn, np.stack([np.eye(3)] * 2).astype(np.float32),
                np.float32([[0, 0, 0], [0.05, 0, 0]]), resolution=16, device="cpu")
assert vol.tsdf.shape == (16, 16, 16) and len(extract_mesh(vol)[1]) > 0
import tempfile
from recon3d_tpu_torch import *
from recon3d_tpu_torch.dense.sift_dense import dense_pairs
from recon3d_tpu_torch.dense.filters import bbox_voxel_downsample, knn_statistical_filter
from recon3d_tpu_torch.runtime.checkpoint import StageCheckpointer
from recon3d_tpu_torch.runtime.profiling import maybe_trace
assert len(dense_pairs(50, 8)) == 400
pts = np.random.default_rng(0).random((200, 3)).astype(np.float32)
assert 0 < len(bbox_voxel_downsample(*knn_statistical_filter(pts, None))[0]) <= 200
with tempfile.TemporaryDirectory() as tmp:
    StageCheckpointer(tmp).save_depth(0, d[0], d[0])
    with maybe_trace(tmp, "cpu"):
        torch.ones(3).sum()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "recon3d_tpu"
             or m.startswith("recon3d_tpu."))
print("BAD", bad)
assert not bad, bad
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted((REPO / "recon3d_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    offenders = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax") or top == "recon3d_tpu":
                offenders.append(f"{f.relative_to(REPO)}: {mod}")
    assert not offenders, offenders
