"""Every public name of the JAX package at its module path in the port.

One case per module of recon3d_tpu/: each public top-level name that the
JAX module defines (a def, a class or an assignment, found with `ast`;
imports excluded) exists in the port's module of the same path, and each
parameter name of a JAX function is accepted by the port's function
(inspect.signature; **kwargs accepts all). Extra port parameters
(device=, timer=, ...) are allowed. What differs on purpose stands in
DEVIATIONS and TPU_ONLY, each with its reason; anything else must match.

Below them, the five names that a caller importing by module path once
missed, each against its JAX counterpart on the same numpy inputs.
"""

import ast
import importlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "recon3d_tpu"
PORT_PKG = REPO / "recon3d_tpu_torch"
MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))

RANDOM = ("jax.random keys cannot be reproduced in torch: the port takes torch "
          "generators, or pre-drawn samples or fields")
FAST = "TPU-only: `fast` selects an MXU path and is a no-op on the JAX CPU branch"
MODULE = ("the port fills or reads a torch nn.Module where the JAX function takes "
          "a Flax parameter tree")

# (JAX module, function) -> ({JAX parameter: the port's, or None where the
# port drops it}, reason).
DEVIATIONS = {
    ("ops/ransac.py", "sample_indices"): ({"key": "generator"}, RANDOM),
    ("ops/ransac.py", "sample_masks"): ({"key": "generator"}, RANDOM),
    ("ops/ransac.py", "ransac"): ({"key": "generator"}, RANDOM),
    ("ops/ransac.py", "ransac_with_refit"): ({"key": "generator"}, RANDOM),
    ("ops/pnp.py", "pnp_ransac"): ({"key": "generator"}, RANDOM),
    ("ops/pnp.py", "pnp_ransac_multi"): ({"key": "generator"}, RANDOM),
    ("ops/estimation.py", "estimate_fundamental_ransac"): ({"key": "generator"}, RANDOM),
    ("ops/estimation.py", "estimate_homography_ransac"): ({"key": "generator"}, RANDOM),
    ("ops/estimation.py", "estimate_essential_ransac"): ({"key": "generator"}, RANDOM),
    ("ops/estimation.py", "estimate_pose_pnp"): ({"key": "generator"}, RANDOM),
    ("ops/estimation.py", "estimate_pose_pnp_wave"): ({"keys": "generator"}, RANDOM),
    ("ops/estimation.py", "estimate_pose_pnp_wave_indexed"): ({"keys": "generator"}, RANDOM),
    ("features/frontend.py", "match_pairs_batched"): ({"key": "generator"}, RANDOM),
    ("neural/train.py", "create_train_state"): ({"key": "generator"}, RANDOM),
    ("dense/patchmatch.py", "patchmatch_depth_batch"): ({"keys": "generators"}, RANDOM),
    ("dense/distributed.py", "distributed_patchmatch"): ({"keys": "coarse_fields"}, RANDOM),
    ("ops/pnp.py", "pnp_dlt"): ({"fast": None}, FAST),
    ("ops/epipolar.py", "fundamental_8point"): ({"fast": None}, FAST),
    ("ops/epipolar.py", "homography_dlt"): ({"fast": None}, FAST),
    ("ops/linalg.py", "smallest_eigvec"): ({"fast": None}, FAST),
    ("neural/weights.py", "save_params_npz"): ({"params": "module"}, MODULE),
    ("neural/weights.py", "load_superpoint_torch"): ({"template": "module"}, MODULE),
    ("neural/weights.py", "load_lightglue_torch"): ({"template": "module"}, MODULE),
}
# Names the port does not define: TPU-only branches (the MXU tent matmul
# and its size limit, the banded box filter), not ported by convention.
TPU_ONLY = {
    ("ops/image.py", "bilinear_sample_mxu"),
    ("ops/image.py", "_box_filter_mxu"),
    ("ops/image.py", "_MXU_SAMPLE_MAX_PIXELS"),
}
# The one JAX module without a counterpart: its Pallas kernel K1 is the
# port's hand-written CUDA kernel and its wrapper.
K1_MODULE = "ops/warp_pallas.py"
K1_PORT = ("csrc/warp.cu", "kernels/warp.py")


def jax_names(path: Path) -> dict:
    """The public top-level definitions of a module: {name: ast node}."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
    return {n: node for n, node in out.items() if not n.startswith("_")}


def port_module(rel: str):
    name = "recon3d_tpu_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def test_the_deviation_table_names_real_parameters():
    """Every entry of DEVIATIONS is a parameter of the JAX function, and
    every TPU_ONLY name a definition of the JAX module: the table cannot
    outlive what it excuses."""
    for (rel, fn), (renames, _) in DEVIATIONS.items():
        node = ast.parse((JAX_PKG / rel).read_text())
        args = next(n.args for n in node.body
                    if isinstance(n, ast.FunctionDef) and n.name == fn)
        params = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
        assert set(renames) <= params, (rel, fn)
    for rel, name in TPU_ONLY:
        tree = ast.parse((JAX_PKG / rel).read_text())
        defined = {getattr(n, "name", None) for n in tree.body} | {
            t.id for n in tree.body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)}
        assert name in defined, (rel, name)


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_at_module_path(rel):
    if rel == K1_MODULE:
        assert not (PORT_PKG / rel).exists()
        assert all((PORT_PKG / p).exists() for p in K1_PORT)
        return
    mod = port_module(rel)
    for name in (name for r, name in TPU_ONLY if r == rel):
        assert not hasattr(mod, name), f"{rel}::{name} is TPU-only but the port defines it"
    missing, refused = [], []
    for name, node in jax_names(JAX_PKG / rel).items():
        if (rel, name) in TPU_ONLY:
            continue
        if not hasattr(mod, name):
            missing.append(name)
            continue
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        renames = DEVIATIONS.get((rel, name), ({}, None))[0]
        params = inspect.signature(getattr(mod, name)).parameters
        takes_any = any(p.kind is p.VAR_KEYWORD for p in params.values())
        a = node.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            want = renames.get(arg.arg, arg.arg)
            if want is not None and want not in params and not takes_any:
                refused.append(f"{name}({arg.arg})")
        if a.vararg and not any(p.kind is p.VAR_POSITIONAL for p in params.values()):
            refused.append(f"{name}(*{a.vararg.arg})")
    assert not missing, f"{rel}: the port lacks {missing}"
    assert not refused, f"{rel}: the port refuses the JAX parameters {refused}"


# ---- the five repaired names against their JAX counterparts -------------


def test_load_params_npz_at_neural_weights(tmp_path):
    """neural/weights.load_params_npz(path, template) fills the module with
    exactly what the JAX function puts in its tree from one checkpoint;
    convert.load_params_npz is the same function; both refuse a file that
    misses a parameter with KeyError."""
    from recon3d_tpu.neural import weights as jw
    from recon3d_tpu.neural.superpoint import SuperPointNet as JaxSuperPoint
    from recon3d_tpu_torch import convert
    from recon3d_tpu_torch.neural import weights as tw
    from recon3d_tpu_torch.neural.superpoint import SuperPointNet

    assert convert.load_params_npz is tw.load_params_npz
    params = JaxSuperPoint().init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 1)))
    path = tmp_path / "sp.npz"
    jw.save_params_npz(jax.device_get(params), str(path))
    ref = jw.load_params_npz(str(path), params)
    net = SuperPointNet()
    assert tw.load_params_npz(path, template=net) is net
    ours = tw.state_dict_to_flax(net)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(ours)
    for keys, leaf in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in keys)
        np.testing.assert_array_equal(ours[key], np.asarray(leaf, np.float32))

    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    stored.pop(sorted(stored)[0])
    partial = tmp_path / "partial.npz"
    np.savez(partial, **stored)
    with pytest.raises(KeyError):
        jw.load_params_npz(str(partial), params)
    with pytest.raises(KeyError):
        tw.load_params_npz(partial, SuperPointNet())


@pytest.mark.parametrize("min_devices", [1, 2, 8, 9])
def test_auto_mesh_follows_the_device_count(monkeypatch, min_devices):
    """auto_mesh over the JAX tests' 8 virtual devices and the port's over
    8 GPUs (the count and make_mesh stubbed: this host has no GPU) agree: a
    data-parallel (8, 1) mesh, or None below min_devices. On this host,
    with no GPU, the port's is None, as the JAX one on one device."""
    from recon3d_tpu.parallel import mesh as jmesh
    from recon3d_tpu_torch.config import MeshConfig
    from recon3d_tpu_torch.parallel import mesh as tmesh

    if torch.cuda.device_count() == 0:
        assert tmesh.auto_mesh(min_devices) is None
    n = len(jax.devices())
    ref = jmesh.auto_mesh(min_devices)
    built = []

    def fake_make_mesh(config, devices, device):
        built.append((tmesh.mesh_shape(config, devices), device))
        return "mesh"

    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(tmesh, "make_mesh", fake_make_mesh)
    got = tmesh.auto_mesh(min_devices)
    if ref is None:
        assert got is None and not built
    else:
        assert got == "mesh"
        assert built == [(tuple(ref.devices.shape), "cuda")]
        assert tmesh.mesh_shape(MeshConfig(model_parallel=1), n) == ref.devices.shape


def test_ncc_windowed_xla_is_ncc_windowed():
    """ncc_windowed_xla, the JAX alias, on the same inputs in both packages."""
    from recon3d_tpu.ops import ncc as jncc
    from recon3d_tpu_torch.ops import ncc as tncc

    assert tncc.ncc_windowed_xla is tncc.ncc_windowed
    rng = np.random.default_rng(5)
    ref = rng.random((24, 32), np.float32)
    src = rng.random((3, 24, 32), np.float32)
    ok = rng.random((3, 24, 32)) > 0.2
    want = np.asarray(jax.jit(jncc.ncc_windowed_xla, static_argnums=3)(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(ok), 7))
    got = tncc.ncc_windowed_xla(torch.from_numpy(ref), torch.from_numpy(src),
                                torch.from_numpy(ok), 7).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("lo", [4, 8192])
def test_fused_points_compact_takes_lo(lo):
    """fused_points_compact(pts, mask, lo=...): the same points and flat
    indices as the JAX function, whatever its capacity bucket."""
    from recon3d_tpu.dense import plane_sweep as jps
    from recon3d_tpu_torch.dense import plane_sweep as tps

    rng = np.random.default_rng(6)
    pts = rng.standard_normal((3, 20, 24, 3)).astype(np.float32)
    mask = rng.random((3, 20, 24)) > 0.7
    want_p, want_i = jps.fused_points_compact(jnp.asarray(pts), jnp.asarray(mask), lo=lo)
    got_p, got_i = tps.fused_points_compact(torch.from_numpy(pts), torch.from_numpy(mask),
                                            lo=lo)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_p, want_p)


def test_load_from_colmap_seeds_the_pipeline_as_jax(tmp_path):
    """cli.load_from_colmap(pipeline, model_dir, image_dir, max_images) on
    one COLMAP text model and its PNGs: the same (points, colors, poses)
    as the JAX function (poses to 1e-6, points equal), and the pipeline
    seeded alike (registered views, K, the loaded images)."""
    from PIL import Image

    from recon3d_tpu import cli as jcli
    from recon3d_tpu.sfm.pipeline import SfMPipeline as JaxPipeline
    from recon3d_tpu_torch import cli as tcli
    from recon3d_tpu_torch.io.colmap import save_colmap_text
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    rng = np.random.default_rng(7)
    V, H, W = 4, 48, 64
    K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    names = [f"v{i}.png" for i in range(V)]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(img_dir / name)
    poses = {}
    for i in range(V):
        a = 0.1 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        poses[i] = (R.astype(np.float32), np.array([0.2 * i, 0.0, 1.0], np.float32))
    points = rng.standard_normal((30, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (30, 3)).astype(np.uint8)
    save_colmap_text(str(tmp_path / "model"), K, (H, W), poses, points, colors, names=names)

    jpipe, tpipe = JaxPipeline(), SfMPipeline(device="cpu")
    jp, jc, jposes = jcli.load_from_colmap(jpipe, str(tmp_path / "model"), str(img_dir), 3)
    tp, tc, tposes = tcli.load_from_colmap(tpipe, str(tmp_path / "model"), str(img_dir),
                                           max_images=3)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)
    assert sorted(tposes) == sorted(jposes) == [0, 1, 2]
    for v in jposes:
        for got, want in zip(tposes[v], jposes[v]):
            np.testing.assert_allclose(got, want, atol=1e-6)
    assert tpipe.registered == jpipe.registered
    np.testing.assert_array_equal(tpipe.points3d, np.asarray(jpipe.points3d))
    np.testing.assert_array_equal(tpipe.point_colors, np.asarray(jpipe.point_colors))
    np.testing.assert_allclose(tpipe.camera.K.numpy(), np.asarray(jpipe.camera.K), atol=1e-6)
    np.testing.assert_array_equal(tpipe.image_set.color, jpipe.image_set.color)
    assert tpipe.image_set.names == jpipe.image_set.names
