"""End-to-end: the port's CLI against the JAX CLI on rendered views: SfM
(`images --fast`, with --export-colmap, --stats-json and --checkpoint-dir)
on the 5 views of tests/test_cli.py, `images --mvs --mesh --stereo` on the
port alone, and `--mvs`, `--stereo --mesh`, `--dense` and `--combined` with
`--from-colmap` and a COLMAP model made from the ground-truth poses, with
PatchMatch's depth checkpoints and --profile; `images --global-sfm` and
`images --neural` on the port alone."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from recon3d_tpu.cli import main as jax_main
from recon3d_tpu.io.colmap import load_colmap_text as jax_load_colmap_text
from recon3d_tpu_torch.cli import build_parser, main
from recon3d_tpu_torch.io.colmap import load_colmap_text, save_colmap_text
from recon3d_tpu_torch.io.ply import load_mesh_ply, load_ply
from tests.render import render_views
from tests.torch_scene import sparse_from_depth, surface_gate

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_cli")
    img_dir = root / "images"
    img_dir.mkdir()
    scene = render_views(n_views=6, image_size=(128, 160), arc_step=0.15)
    names = [f"im_{i:03d}.png" for i in range(6)]
    for name, img in zip(names, scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / name)
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(6)}
    save_colmap_text(str(root / "model"), scene["K"], (128, 160), poses,
                     sparse_from_depth(scene, per_view=300), None, names=names)
    return str(img_dir), str(root / "model")


def test_cli_mvs_from_colmap_matches_jax_cli(colmap_scene, tmp_path):
    img_dir, model = colmap_scene
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_main([img_dir, "--mvs", "--from-colmap", model, "--output", str(out_j)]) == 0
    stats = tmp_path / "stats.json"
    assert main([img_dir, "--mvs", "--from-colmap", model, "--output", str(out_t),
                 "--device", "cpu", "--stats-json", str(stats)]) == 0

    # sparse.ply and cameras.ply are 6-decimal ASCII: 1e-6 of text rounding
    # plus float32 rounding of camera centres of magnitude ~3.5 (4e-7)
    for name in ("sparse.ply", "cameras.ply"):
        a, ca = load_ply(str(out_t / name))
        b, cb = load_ply(str(out_j / name))
        np.testing.assert_allclose(a, b, atol=1e-6 + 5e-7, rtol=0)
        np.testing.assert_array_equal(ca, cb)
    pa, pb = np.load(out_t / "poses.npz"), np.load(out_j / "poses.npz")
    for k in ("image_ids", "Rs", "ts"):
        np.testing.assert_allclose(pa[k], pb[k], atol=1e-6, rtol=0)

    # At the CLI's settings these 128x160 views give 32x40 working maps, where
    # the reference itself lands at median 0.22-0.36 and share 0.28-0.38
    # (seeds 0-3), far from test_full_mvs_reconstructor's 0.1 / 0.6 (which
    # tests/test_torch_patchmatch.py holds at full resolution). Both CLIs
    # are held to a gate that every one of those reference runs passes.
    dt, _ = load_ply(str(out_t / "dense_mvs.ply"))
    dj, _ = load_ply(str(out_j / "dense_mvs.ply"))
    for pts in (dt, dj):
        med, frac = surface_gate(pts)
        assert med < 0.4 and frac > 0.25, (med, frac)
    assert 0.8 <= len(dt) / len(dj) <= 1.25, (len(dt), len(dj))
    s = json.loads(stats.read_text())
    assert s["num_dense_points"] == len(dt) and s["device"] == "cpu"
    assert set(s["stage_times_s"]) == {"sparse_sfm", "patchmatch_mvs"}


@pytest.mark.parametrize("flags", [["--devices", "2"]])
def test_unported_modes_exit_nonzero(colmap_scene, tmp_path, flags, capsys):
    img_dir, model = colmap_scene
    argv = [img_dir, "--mvs", "--output", str(tmp_path / "o"), "--device", "cpu", *flags,
            "--from-colmap", model]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None)
    assert "not yet ported" in str(e.value.code)
    assert "ROADMAP.md, section 1, item" in str(e.value.code)
    assert not (tmp_path / "o").exists()


# ---------------------------------------------------------------------------
# SfM in front: images without --from-colmap


@pytest.fixture(scope="module")
def sfm_scene(tmp_path_factory):
    """The 5 views of 128x160 of tests/test_cli.py:13-22 as PNGs."""
    from PIL import Image

    d = tmp_path_factory.mktemp("torch_cli_sfm")
    scene = render_views(n_views=5, image_size=(128, 160), arc_step=0.15)
    for i, img in enumerate(scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(d / f"im_{i:03d}.png")
    return str(d), scene


def _sparse_mode_run(img_dir, tmp_path, mode):
    """`IMAGES <mode>` through the port's CLI on the CPU: sparse.ply,
    cameras.ply and poses.npz of every view, and the run's stats."""
    out, stats = tmp_path / "out", tmp_path / "stats.json"
    assert main([img_dir, mode, "--output", str(out), "--stats-json", str(stats),
                 "--device", "cpu"]) == 0
    st = json.loads(stats.read_text())
    pts, cols = load_ply(str(out / "sparse.ply"))
    assert len(pts) == st["num_points"] == st["num_sparse_points"] > 30
    assert np.isfinite(pts).all() and cols.shape == pts.shape
    assert st["num_cameras"] == 5 and st["mean_reproj_px"] < 1.5
    assert len(np.load(out / "poses.npz")["image_ids"]) == 5
    assert (out / "cameras.ply").exists()
    return st


def test_cli_images_global_sfm(sfm_scene, tmp_path):
    img_dir, _ = sfm_scene
    st = _sparse_mode_run(img_dir, tmp_path, "--global-sfm")
    assert st["global_solve_time"] > 0


def test_cli_images_neural(tmp_path):
    """`IMAGES --neural`: SuperPoint with the bundled weights and the nn
    matcher at the default NeuralConfig, on 5 views of 192x256. (On the 5
    views of 128x160 SuperPoint finds about 68 keypoints a view, and the
    JAX CLI's --neural, like the port's, finds no initial pair there.)"""
    from PIL import Image

    scene = render_views(n_views=5, image_size=(192, 256), arc_step=0.15)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, img in enumerate(scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / f"im_{i:03d}.png")
    st = _sparse_mode_run(str(img_dir), tmp_path, "--neural")
    assert min(st["features_per_image"]) > 100 and "global_solve_time" not in st
    assert st["k1_calls_by_stage"]["sparse_sfm"]["plain"] == 5     # one sampling a view


@pytest.fixture(scope="module")
def fast_runs(sfm_scene, tmp_path_factory):
    """`images --fast` through both CLIs (the JAX one on one device, as the
    port runs), the port's with --export-colmap."""
    img_dir, _ = sfm_scene
    root = tmp_path_factory.mktemp("torch_cli_fast")
    common = [img_dir, "--fast", "--seed", "1"]
    assert jax_main(common + ["--output", str(root / "jax"), "--devices", "1",
                              "--stats-json", str(root / "jax.json")]) == 0
    assert main(common + ["--output", str(root / "torch"), "--export-colmap",
                          "--device", "cpu", "--stats-json", str(root / "torch.json")]) == 0
    return {k: (root / k, json.loads((root / f"{k}.json").read_text())) for k in ("jax", "torch")}


def test_cli_sfm_matches_jax_cli(fast_runs):
    """Both CLIs register the same cameras, with mean reprojection errors
    within 0.1 px of each other or both below 1 px, and write sparse.ply,
    cameras.ply and poses.npz for them."""
    (out_j, s_j), (out_t, s_t) = fast_runs["jax"], fast_runs["torch"]
    ids_j, ids_t = (np.load(o / "poses.npz")["image_ids"] for o in (out_j, out_t))
    np.testing.assert_array_equal(ids_t, ids_j)
    assert s_t["num_cameras"] == s_j["num_cameras"] == len(ids_t) >= 4
    e_t, e_j = s_t["mean_reproj_px"], s_j["mean_reproj_px"]
    assert abs(e_t - e_j) < 0.1 or (e_t < 1.0 and e_j < 1.0), (e_t, e_j)
    pts, cols = load_ply(str(out_t / "sparse.ply"))
    assert len(pts) > 100 and cols.shape == pts.shape and s_t["num_sparse_points"] == len(pts)
    cams, _ = load_ply(str(out_t / "cameras.ply"))
    assert len(cams) == 2 * len(ids_t)
    assert not (out_t / "dense_mvs.ply").exists()


def test_cli_export_colmap_round_trips(fast_runs, sfm_scene):
    """sparse_colmap/ reads back through both packages' load_colmap_text:
    the poses of poses.npz to 1e-5, the sparse points, the shared camera,
    and image names that exist on disk (the --from-colmap contract)."""
    img_dir, _ = sfm_scene
    out, _ = fast_runs["torch"]
    poses = np.load(out / "poses.npz")
    pts, _ = load_ply(str(out / "sparse.ply"))
    for load in (load_colmap_text, jax_load_colmap_text):
        m = load(str(out / "sparse_colmap"))
        assert len(m.images) == len(poses["image_ids"]) and len(m.cameras) == 1
        by_name = {im.name: im for im in m.images.values()}
        for k, i in enumerate(poses["image_ids"]):
            im = by_name[f"im_{i:03d}.png"]
            np.testing.assert_allclose(im.R(), poses["Rs"][k], atol=1e-5)
            np.testing.assert_allclose(im.t, poses["ts"][k], atol=1e-5)
            assert (Path(img_dir) / im.name).exists()
        np.testing.assert_allclose(m.points, pts, atol=1e-5)
        assert all(len(tr) >= 2 for tr in m.tracks)


def test_cli_stats_json(fast_runs):
    """The port's --stats-json holds every key of the JAX CLI's (the
    pipeline's stats, stage_times_s, num_sparse_points) and names its
    device; the sparse stage is the only one timed in a --fast run."""
    (_, s_j), (_, s_t) = fast_runs["jax"], fast_runs["torch"]
    assert set(s_j) <= set(s_t), set(s_j) - set(s_t)
    assert set(s_t["stage_times_s"]) == {"sparse_sfm"} == set(s_j["stage_times_s"])
    assert s_t["device"] == "cpu" and s_t["k1_calls_by_stage"] == {}
    for k in ("load_time", "extract_time", "match_time", "init_time", "incremental_time",
              "final_ba_time", "total_time"):
        assert s_t[k] >= 0.0


@pytest.fixture(scope="module")
def dense_run(sfm_scene, tmp_path_factory):
    """`images --mvs --mesh --stereo` through the port's CLI on the CPU."""
    img_dir, _ = sfm_scene
    out = tmp_path_factory.mktemp("torch_cli_dense")
    assert main([img_dir, "--mvs", "--mesh", "--stereo", "--mesh-resolution", "64",
                 "--seed", "1", "--output", str(out / "r"), "--device", "cpu",
                 "--stats-json", str(out / "s.json")]) == 0
    return out / "r", json.loads((out / "s.json").read_text())


def test_cli_images_mvs_mesh(dense_run):
    """tests/test_cli.py::test_cli_mesh_end_to_end (slow there) on the port
    at --mesh-resolution 64: dense_mvs.ply beside a coloured mesh.ply whose
    faces index its vertices, and each dense stage took K1's plain version
    on the CPU (the TSDF stage once a view). The surfaces are not gated
    here: 5 views of 128x160 give too few features for SfM cameras good
    enough to hold a cloud to the true planes (tests/test_torch_sfm_back.py
    holds SfM, the --from-colmap tests hold the dense stages)."""
    out, stats = dense_run
    verts, faces, cols = load_mesh_ply(str(out / "mesh.ply"))
    assert len(verts) > 200 and len(faces) > 400
    assert cols is not None and cols.shape == verts.shape
    assert faces.min() >= 0 and faces.max() < len(verts)
    assert stats["mesh_vertices"] == len(verts) and stats["mesh_faces"] == len(faces)
    dense, dcols = load_ply(str(out / "dense_mvs.ply"))
    assert len(dense) == stats["num_dense_points"] > 1000 and dcols.shape == dense.shape
    assert np.isfinite(dense).all()
    assert set(stats["stage_times_s"]) == {"sparse_sfm", "patchmatch_mvs", "plane_sweep",
                                           "tsdf_mesh"}
    k1 = stats["k1_calls_by_stage"]
    assert k1["tsdf_mesh"] == {"kernel": 0, "plain": stats["num_cameras"],
                               "kernel_by_shape": {}, "kernel_by_variant": {}}
    assert all(k1[s]["kernel"] == 0 and k1[s]["plain"] > 0
               for s in ("patchmatch_mvs", "plane_sweep"))


def test_cli_images_stereo(dense_run):
    """--stereo beside --mvs writes dense_stereo.ply, finite and coloured,
    in the frame of the SfM cameras: in front of the first of them."""
    out, stats = dense_run
    pts, cols = load_ply(str(out / "dense_stereo.ply"))
    assert len(pts) == stats["num_stereo_points"] > 1000 and cols.shape == pts.shape
    assert np.isfinite(pts).all()
    p = np.load(out / "poses.npz")
    z = (pts @ p["Rs"][0].T + p["ts"][0])[:, 2]
    assert (z > 0).mean() > 0.95


def test_cli_stereo_mesh_from_colmap_matches_jax_cli(colmap_scene, tmp_path):
    """--stereo --mesh --from-colmap: the mesh fuses the plane-sweep maps
    (no --mvs) in both CLIs; stereo point counts within 10% of each other,
    both clouds near the true surfaces, both meshes non-empty."""
    img_dir, model = colmap_scene
    argv = [img_dir, "--stereo", "--mesh", "--mesh-resolution", "48", "--from-colmap", model]
    assert jax_main(argv + ["--output", str(tmp_path / "jax"), "--devices", "1"]) == 0
    assert main(argv + ["--output", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    clouds = [load_ply(str(tmp_path / k / "dense_stereo.ply"))[0] for k in ("torch", "jax")]
    assert 0.9 <= len(clouds[0]) / len(clouds[1]) <= 1.1, [len(c) for c in clouds]
    for pts in clouds:
        med, _ = surface_gate(pts)
        assert med < 0.4, med
    for k in ("torch", "jax"):
        assert not (tmp_path / k / "dense_mvs.ply").exists()
        verts, faces, _ = load_mesh_ply(str(tmp_path / k / "mesh.ply"))
        assert len(faces) > 100 and faces.max() < len(verts)


def test_device_flag(colmap_scene, tmp_path):
    args = build_parser().parse_args(["x", "--from-colmap", "m"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    img_dir, model = colmap_scene
    with pytest.raises(RuntimeError, match="cuda"):
        main([img_dir, "--from-colmap", model, "--output", str(tmp_path / "o")])


# ---------------------------------------------------------------------------
# Dense SIFT (--dense, --combined), checkpoints and the trace


@pytest.fixture(scope="module")
def jax_combined(colmap_scene, tmp_path_factory):
    """The JAX CLI's `--combined --from-colmap`: the plane sweep and dense
    SIFT, on one device."""
    img_dir, model = colmap_scene
    out = tmp_path_factory.mktemp("torch_cli_combined") / "jax"
    assert jax_main([img_dir, "--combined", "--from-colmap", model, "--output", str(out),
                     "--devices", "1"]) == 0
    return out


@pytest.mark.parametrize("flag", ["--dense", "--combined"])
def test_cli_dense_sift_matches_jax_cli(colmap_scene, jax_combined, flag, tmp_path):
    """--dense writes dense.ply (dense SIFT) and --combined writes it beside
    dense_stereo.ply (the sweep), as the JAX CLI does; point counts within
    0.8-1.25 of the JAX CLI's, and the clouds near the true surfaces."""
    img_dir, model = colmap_scene
    out, stats = tmp_path / "torch", tmp_path / "s.json"
    assert main([img_dir, flag, "--from-colmap", model, "--output", str(out),
                 "--device", "cpu", "--stats-json", str(stats)]) == 0
    s = json.loads(stats.read_text())
    names = ["dense.ply"] + (["dense_stereo.ply"] if flag == "--combined" else [])
    assert set(s["stage_times_s"]) == {"sparse_sfm", "dense_sift"} | (
        {"plane_sweep"} if flag == "--combined" else set())
    assert not (out / "dense_mvs.ply").exists()
    assert (out / "dense_stereo.ply").exists() == (flag == "--combined")
    for name in names:
        pt, ct = load_ply(str(out / name))
        pj, _ = load_ply(str(jax_combined / name))
        assert 0.8 <= len(pt) / len(pj) <= 1.25, (name, len(pt), len(pj))
        assert ct.shape == pt.shape and np.isfinite(pt).all()
        med, _ = surface_gate(pt)
        assert med < 0.4, (name, med)
    dense, _ = load_ply(str(out / "dense.ply"))
    assert s["num_dense_sift_points"] == len(dense)
    st = s["dense_sift_breakdown"]
    assert st["pairs"] == 15 and st["capacity"] >= 256 and st["knn_path"] in ("native", "scipy")
    if flag == "--combined":
        assert s["k1_calls_by_stage"]["plane_sweep"]["plain"] > 0


def test_cli_checkpoint_resume(sfm_scene, tmp_path):
    """tests/test_cli.py::test_cli_checkpoint_resume on the port: the second
    run restores the sparse state instead of running SfM."""
    img_dir, _ = sfm_scene
    out1, ck = tmp_path / "r1", tmp_path / "ckpt"
    assert main([img_dir, "--fast", "--output", str(out1), "--checkpoint-dir", str(ck),
                 "--device", "cpu"]) == 0
    assert (ck / "sparse_state.npz").exists()
    pts1, _ = load_ply(str(out1 / "sparse.ply"))

    out2, stats = tmp_path / "r2", tmp_path / "s.json"
    assert main([img_dir, "--fast", "--output", str(out2), "--checkpoint-dir", str(ck),
                 "--device", "cpu", "--stats-json", str(stats)]) == 0
    pts2, _ = load_ply(str(out2 / "sparse.ply"))
    np.testing.assert_allclose(pts1, pts2, atol=1e-5)
    np.testing.assert_array_equal(np.load(out1 / "poses.npz")["Rs"],
                                  np.load(out2 / "poses.npz")["Rs"])
    assert "extract_time" not in json.loads(stats.read_text())   # SfM did not run


def test_cli_restores_a_jax_sparse_checkpoint(sfm_scene, tmp_path):
    """A sparse checkpoint the JAX CLI wrote restores in the port's CLI:
    the JAX run's sparse.ply and poses come back."""
    img_dir, _ = sfm_scene
    ck = tmp_path / "ckpt"
    assert jax_main([img_dir, "--fast", "--seed", "1", "--output", str(tmp_path / "jax"),
                     "--devices", "1", "--checkpoint-dir", str(ck)]) == 0
    assert main([img_dir, "--fast", "--output", str(tmp_path / "torch"),
                 "--checkpoint-dir", str(ck), "--device", "cpu"]) == 0
    a, _ = load_ply(str(tmp_path / "torch" / "sparse.ply"))
    b, _ = load_ply(str(tmp_path / "jax" / "sparse.ply"))
    np.testing.assert_array_equal(a, b)
    pa, pb = np.load(tmp_path / "torch" / "poses.npz"), np.load(tmp_path / "jax" / "poses.npz")
    for k in ("image_ids", "Rs", "ts"):
        np.testing.assert_array_equal(pa[k], pb[k])


def test_cli_mvs_depth_checkpoints_resume(colmap_scene, tmp_path):
    """--mvs --from-colmap --checkpoint-dir: the model's poses skip the
    sparse checkpoint (as in the JAX CLI); a rerun after two of the six
    depth maps are lost recomputes them and writes the same dense_mvs.ply."""
    img_dir, model = colmap_scene
    ck = tmp_path / "ck"
    argv = [img_dir, "--mvs", "--from-colmap", model, "--checkpoint-dir", str(ck),
            "--device", "cpu"]
    assert main(argv + ["--output", str(tmp_path / "r1")]) == 0
    assert not (ck / "sparse_state.npz").exists()
    maps = sorted((ck / "depth_maps").iterdir())
    assert len(maps) == 6
    for m in maps[2:4]:
        m.unlink()
    assert main(argv + ["--output", str(tmp_path / "r2")]) == 0
    a, ca = load_ply(str(tmp_path / "r1" / "dense_mvs.ply"))
    b, cb = load_ply(str(tmp_path / "r2" / "dense_mvs.ply"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    assert len(sorted((ck / "depth_maps").iterdir())) == 6


def test_cli_profile_writes_a_trace(colmap_scene, tmp_path, capsys):
    """--profile on the CPU: a torch.profiler Chrome trace of the run (CPU
    activity: the CPU build refuses CUDA activity) that loads as JSON."""
    from recon3d_tpu_torch.runtime.profiling import TRACE_NAME

    img_dir, model = colmap_scene
    prof = tmp_path / "prof"
    assert main([img_dir, "--stereo", "--from-colmap", model, "--output", str(tmp_path / "o"),
                 "--device", "cpu", "--profile", str(prof)]) == 0
    assert f"[profile] device trace written to {prof}" in capsys.readouterr().out
    trace = json.loads((prof / TRACE_NAME).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert (tmp_path / "o" / "dense_stereo.ply").exists()
