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
from recon3d_tpu_torch.sfm.global_sfm import rotation_averaging, translation_averaging
Rr = np.stack([np.eye(3, dtype=np.float32)] * 3)
ei, ej = np.array([0, 1, 0], np.int32), np.array([1, 2, 2], np.int32)
R, seen = rotation_averaging(ei, ej, Rr, np.ones(3, np.float32), 3, device="cpu")
assert seen.all() and np.allclose(R, np.eye(3), atol=1e-6)
from recon3d_tpu_torch.neural import NeuralMatcher
from recon3d_tpu_torch.config import NeuralConfig
nf = NeuralMatcher(NeuralConfig(max_keypoints=64), device="cpu").extract(g[0].repeat(2, 0).repeat(2, 1))
assert nf.desc.shape == (64, 256) and torch.isfinite(nf.desc).all()
import recon3d_tpu_torch.neural.pretrain
from recon3d_tpu_torch.convert import load_params_npz
from recon3d_tpu_torch.neural.superpoint import SuperPointNet
from recon3d_tpu_torch.neural.synthetic import make_pair_batch_compact
from recon3d_tpu_torch.neural.train import Adam, TrainState, _lightglue_loss, make_epoch_train_fn
from recon3d_tpu_torch.neural.weights import flax_init_, save_params_npz
cb = make_pair_batch_compact(np.random.default_rng(0), 2, (32, 32))
net = flax_init_(SuperPointNet(), torch.Generator().manual_seed(0))
tx = Adam(1e-3)
_, losses = make_epoch_train_fn(net, tx, epochs=1)(
    TrainState(net, tx.init(net.parameters())), {k: torch.from_numpy(v[None]) for k, v in cb.items()})
assert losses.shape == (1, 3) and torch.isfinite(losses).all()
la = torch.log_softmax(torch.randn(1, 5, 4), -1)
lg = _lightglue_loss(la, torch.rand(1, 5), torch.rand(1, 4), torch.tensor([[0, 0, -1, -2, 3]]),
                     torch.ones(1, 5, dtype=torch.bool), torch.ones(1, 4, dtype=torch.bool))
assert all(torch.isfinite(v).all() for v in lg)
with tempfile.TemporaryDirectory() as tmp:
    save_params_npz(net, tmp + "/sp.npz")
    back = load_params_npz(tmp + "/sp.npz", SuperPointNet())
    assert torch.equal(back.conv1a.weight, net.conv1a.weight.half().float())
from recon3d_tpu_torch.dense.distributed import distributed_plane_sweep
from recon3d_tpu_torch.parallel import make_mesh
from recon3d_tpu_torch.parallel.workers import probe
with make_mesh(devices=2, device="cpu") as mesh:
    out = mesh.call(probe, [{"value": 1}, {"value": 2}])
    assert [o["sum"] for o in out] == [3.0, 3.0]
    worker_pkgs = out[1]["packages"]
    eye = np.eye(3, dtype=np.float32)
    d, c, _ = distributed_plane_sweep(
        g[:2], np.stack([g[2:4], g[3:5]]), K.numpy(), np.stack([eye] * 2), np.zeros((2, 3)),
        np.stack([[eye, eye]] * 2), np.float32([[[0.1, 0, 0], [0.2, 0, 0]]] * 2),
        np.float32([1.0, 5.0]), mesh=mesh, num_depths=8)
    assert d.shape == (2, 32, 40) and np.isfinite(d).all()
assert "torch" in worker_pkgs and "recon3d_tpu_torch" in worker_pkgs
assert not {"jax", "jaxlib", "recon3d_tpu"} & set(worker_pkgs), worker_pkgs
import recon3d_tpu_torch.calib, recon3d_tpu_torch.runtime.serve, recon3d_tpu_torch.runtime.worker
import recon3d_tpu_torch.gui.viewer, recon3d_tpu_torch.gui.app, recon3d_tpu_torch.tools.run_colmap
import recon3d_tpu_torch.serve
from recon3d_tpu_torch.calib.corners import detect_corners, refine_corners_gradient
cand = detect_corners(torch.from_numpy(g[0]), max_corners=16)
assert cand.xy.shape == (16, 2) and bool(cand.valid[0])
q = refine_corners_gradient(torch.from_numpy(g[0]), cand.xy[:4])
assert q.shape == (4, 2) and torch.isfinite(q).all()
from recon3d_tpu_torch.gui.viewer import render_pointcloud
assert render_pointcloud(pts, None, (24, 32)).shape == (24, 32, 3)
from recon3d_tpu_torch.runtime.worker import build_command
assert build_command("d", {"device": "cpu"})[2] == "recon3d_tpu_torch.cli"
import importlib.util
import bench_cuda
row = bench_cuda.main(["--device", "cpu", "--views", "2", "--windows", "1", "--reps", "1",
                       "--patch", "5", "--iterations", "1"])
assert row["value"] > 0 and row["k1_plain"] > 0
spec = importlib.util.spec_from_file_location("bench_stages_torch", "scripts/bench_stages_torch.py")
stages = importlib.util.module_from_spec(spec)
spec.loader.exec_module(stages)
assert stages.main(["--quick", "--device", "cpu", "--skip", "sift", "match", "sweep",
                    "patchmatch", "bundle"]) == 0
from tests.torch_render import render_views
from tests.torch_robust_check import DIST, tuned_config
assert render_views(n_views=1, image_size=(24, 32), dist=DIST)["images"].shape == (1, 24, 32, 3)
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
    files = sorted((REPO / "recon3d_tpu_torch").rglob("*.py")) + [
        REPO / f for f in ("chip_smoke.py", "bench_cuda.py", "scripts/bench_stages_torch.py",
                           "tests/torch_render.py", "tests/torch_robust_check.py")]
    assert len(files) > 30
    offenders = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax") or top == "recon3d_tpu":
                offenders.append(f"{f.relative_to(REPO)}: {mod}")
    assert not offenders, offenders
