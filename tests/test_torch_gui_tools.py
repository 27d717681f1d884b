"""The port's worker, GUI helpers, viewer renderer and COLMAP wrapper
(recon3d_tpu_torch/{runtime/worker,gui,tools}) on the CPU: the headless
tests of tests/test_worker_gui_tools.py on the port, and parity with the
JAX package's copies. These modules are numpy and subprocess code, so
their outputs are held to the JAX functions' bit for bit on the same
inputs; the worker's argv differs from JAX's only by the module prefix and
the port's --device."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

from recon3d_tpu.gui import app as japp
from recon3d_tpu.gui import viewer as jviewer
from recon3d_tpu.runtime import worker as jworker
from recon3d_tpu.tools import run_colmap as jcolmap
from recon3d_tpu_torch.gui.app import METHOD_PRESETS, collect_options, find_result_file
from recon3d_tpu_torch.gui.viewer import (
    orbit_drag,
    render_pointcloud,
    render_turntable,
    subsample_for_display,
)
from recon3d_tpu_torch.io.ply import save_ply
from recon3d_tpu_torch.runtime.worker import (
    ReconstructionWorker,
    build_command,
    sniff_status,
    status_step,
)
from recon3d_tpu_torch.tools.run_colmap import (
    QUALITY_SETTINGS,
    build_stage_commands,
    find_colmap,
    run_colmap_reconstruction,
)


def test_build_command_mapping():
    cmd = build_command("/d", {"neural": True, "mvs": True, "max_images": 7})
    assert "recon3d_tpu_torch.cli" in cmd and "--neural" in cmd and "--mvs" in cmd
    assert cmd[cmd.index("--max-images") + 1] == "7"
    cmd = build_command("/d", {})
    assert "--fast" in cmd  # sparse default
    cmd = build_command("/d", {"method": "colmap_sparse", "use_gpu": False})
    assert "recon3d_tpu_torch.tools.run_colmap" in cmd
    assert "--sparse-only" in cmd and "--no-gpu" in cmd
    # mvs wins over stereo/dense, like the reference's elif chain
    cmd = build_command("/d", {"mvs": True, "stereo": True, "dense": True})
    assert "--mvs" in cmd and "--stereo" not in cmd and "--dense" not in cmd
    # combined outranks everything; devices pass through
    cmd = build_command("/d", {"combined": True, "mvs": True, "devices": 1})
    assert "--combined" in cmd and "--mvs" not in cmd
    assert cmd[cmd.index("--devices") + 1] == "1"
    # the port's device option becomes --device; COLMAP methods ignore it
    cmd = build_command("/d", {"mvs": True, "device": "cpu"})
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "--device" not in build_command("/d", {"method": "colmap_dense", "device": "cpu"})


def _jax_argv(cmd):
    return [a.replace("recon3d_tpu.", "recon3d_tpu_torch.", 1) for a in cmd]


@pytest.mark.parametrize("label,preset", METHOD_PRESETS)
def test_build_command_matches_jax_for_every_preset(label, preset):
    """Every preset through collect_options and build_command: JAX's argv
    with the module prefix renamed, plus --device when the options carry
    one."""
    assert (label, preset) in japp.METHOD_PRESETS
    for kw in ({}, {"quality": "high", "use_gpu": False, "max_images": 12, "output": "/o",
                    "mesh": True}):
        opts = collect_options(preset, **kw)
        assert opts == japp.collect_options(preset, **kw)
        ref = _jax_argv(jworker.build_command("/d", opts))
        assert build_command("/d", opts) == ref
        with_dev = build_command("/d", {**opts, "device": "cpu"})
        if opts.get("method", "").startswith("colmap"):
            assert with_dev == ref
        else:
            assert with_dev == ref + ["--device", "cpu"]


def test_sniff_status_keywords():
    assert "1/4" in sniff_status("extracting features from 10 images")
    assert "2/4" in sniff_status("[sfm] matching 45 pairs")
    assert "4/4" in sniff_status("[patchmatch] 1234 points")
    assert sniff_status("unrelated line") is None
    for line in ("[sfm] features: 10 images", "[sfm] registered image 3", "sparse recon",
                 "dense_mvs.ply: 10 points", "saved mesh.ply", "", "[colmap] stage 1/4"):
        assert sniff_status(line) == jworker.sniff_status(line)
        assert status_step(sniff_status(line)) == jworker.status_step(sniff_status(line))


def test_status_step_progression():
    lines = [
        "extracting features from 10 images",
        "[sfm] matching 45 pairs",
        "[sfm] registered image 3",
        "[patchmatch] 1234 points",
        "saved dense_mvs.ply",
    ]
    steps = [status_step(sniff_status(line)) for line in lines]
    assert steps == [1, 2, 3, 4, 4]
    assert status_step(None) is None and status_step("idle") is None


def test_collect_options_widget_mapping():
    o = collect_options({"method": "colmap_dense"}, quality="high",
                        use_gpu=False, max_images=50, output="/o")
    assert o["quality"] == "high" and o["use_gpu"] is False
    assert "max_images" not in o and o["output"] == "/o"
    o = collect_options({"neural": True, "mvs": True}, max_images=50)
    assert o["max_images"] == 50 and "quality" not in o
    # the reference's spinbox floor: <=5 means "all images"
    o = collect_options({}, max_images=5)
    assert "max_images" not in o
    o = collect_options({"mvs": True}, serve_socket="/s")
    assert o == japp.collect_options({"mvs": True}, serve_socket="/s") and o["serve_socket"] == "/s"


def test_orbit_drag_math():
    az, el = orbit_drag(30.0, 20.0, dx_px=100, dy_px=-50, deg_per_px=0.4)
    assert az == pytest.approx(70.0) and el == pytest.approx(0.0)
    az, _ = orbit_drag(350.0, 0.0, dx_px=50, dy_px=0)
    assert az == pytest.approx(10.0)
    _, el = orbit_drag(0.0, 80.0, dx_px=0, dy_px=100)
    assert el == 89.0
    assert orbit_drag(12.5, -3.0, 77, -41) == jviewer.orbit_drag(12.5, -3.0, 77, -41)


def test_worker_runs_subprocess(tmp_path):
    """The worker spawns the port's CLI as a real subprocess and streams its
    output; a bad dataset makes the CLI exit non-zero quickly."""
    logs, statuses, done = [], [], []
    w = ReconstructionWorker(on_log=logs.append, on_status=statuses.append,
                             on_finished=done.append)
    ok = w.run(str(tmp_path / "missing_dir"), {"device": "cpu"})
    assert ok is False and done == [False]
    assert any("Executing:" in line and "recon3d_tpu_torch.cli" in line for line in logs)
    assert any("not found" in line for line in logs)


def test_method_presets_and_result_discovery(tmp_path):
    assert len(METHOD_PRESETS) == 10 and METHOD_PRESETS == japp.METHOD_PRESETS
    assert find_result_file(str(tmp_path)) is None
    save_ply(str(tmp_path / "sparse.ply"), np.zeros((1, 3), np.float32))
    save_ply(str(tmp_path / "dense_mvs.ply"), np.zeros((1, 3), np.float32))
    assert find_result_file(str(tmp_path)).endswith("dense_mvs.ply")
    assert find_result_file(str(tmp_path)) == japp.find_result_file(str(tmp_path))


def test_render_pointcloud_and_turntable(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (5000, 3)).astype(np.uint8)
    img = render_pointcloud(pts, cols, image_size=(120, 160))
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    assert (img > 40).any()

    ply = str(tmp_path / "cloud.ply")
    save_ply(ply, pts, cols)
    paths = render_turntable(ply, str(tmp_path / "view"), n_frames=3, image_size=(60, 80))
    assert len(paths) == 3 and all(os.path.exists(p) for p in paths)
    ref = jviewer.render_turntable(ply, str(tmp_path / "jax"), n_frames=3, image_size=(60, 80))
    from PIL import Image

    for a, b in zip(paths, ref):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))

    sub_p, sub_c = subsample_for_display(pts, cols, max_points=100)
    assert len(sub_p) == 100 and len(sub_c) == 100
    ref_p, ref_c = jviewer.subsample_for_display(pts, cols, max_points=100)
    np.testing.assert_array_equal(sub_p, ref_p)
    np.testing.assert_array_equal(sub_c, ref_c)


@pytest.mark.parametrize("kw", [
    {},
    {"point_size": 3, "azimuth_deg": 123.0, "elevation_deg": -30.0},
    {"center": np.float32([0.1, 0.2, 0.3]), "radius": 2.0, "background": 0.5},
])
def test_render_pointcloud_matches_jax(kw):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(20000, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (20000, 3), dtype=np.uint8)
    np.testing.assert_array_equal(render_pointcloud(pts, cols, (90, 120), **kw),
                                  jviewer.render_pointcloud(pts, cols, (90, 120), **kw))
    np.testing.assert_array_equal(render_pointcloud(pts, None, (90, 120), **kw),
                                  jviewer.render_pointcloud(pts, None, (90, 120), **kw))
    assert np.array_equal(render_pointcloud(pts[:0], None, (9, 12)),
                          jviewer.render_pointcloud(pts[:0], None, (9, 12)))


def test_colmap_wrapper_gated(tmp_path):
    cmds = build_stage_commands("colmap", Path("/tmp/x"), use_gpu=False, quality="high",
                                dense=True)
    assert len(cmds) == 7  # 4 sparse + 3 dense stages
    assert cmds[0][1] == "feature_extractor"
    assert "--SiftExtraction.use_gpu" in cmds[0]
    assert any("16384" in c for c in cmds[0])  # high preset
    sparse_only = build_stage_commands("colmap", Path("/tmp/x"), True, "low", dense=False)
    assert len(sparse_only) == 4
    assert QUALITY_SETTINGS == jcolmap.QUALITY_SETTINGS
    for args in (("colmap", Path("/o"), False, "high", True), ("/b/colmap", Path("/p"), True,
                                                               "low", False),
                 ("colmap", Path("/o"), True, "unknown", True)):
        assert build_stage_commands(*args) == jcolmap.build_stage_commands(*args)
    assert find_colmap() == jcolmap.find_colmap()
    if find_colmap() is None:
        # graceful degradation without the binary
        assert run_colmap_reconstruction(str(tmp_path), str(tmp_path / "o")) is False


def test_colmap_missing_names_the_ports_cli(tmp_path, capsys):
    if find_colmap() is not None:
        pytest.skip("a colmap binary is installed here")
    from recon3d_tpu_torch.tools import run_colmap

    assert run_colmap.main([str(tmp_path)]) == 1
    assert "python -m recon3d_tpu_torch.cli" in capsys.readouterr().out
    img = tmp_path / "imgs"
    img.mkdir()
    for name in ("a.png", "b.JPG", "notes.txt"):
        (img / name).write_bytes(b"x")
    assert run_colmap._stage_images(img, tmp_path / "clean") == 2
    assert jcolmap._stage_images(img, tmp_path / "clean_jax") == 2


def test_collect_options_mesh():
    opts = collect_options({"mvs": True}, mesh=True, max_images=10)
    assert opts["mesh"] and opts["max_images"] == 10
    cmd = build_command("imgs", opts)
    assert "--mesh" in cmd and "--mvs" in cmd
    opts = collect_options({"method": "colmap_dense"}, mesh=True)
    assert "mesh" not in opts


def test_app_main_without_qt_names_the_ports_cli():
    from recon3d_tpu_torch.gui import app

    if app.HAS_QT:
        pytest.skip("PyQt5 is installed here")
    with pytest.raises(SystemExit, match="python -m recon3d_tpu_torch.cli"):
        app.main()


def _sphere_mesh(n):
    from recon3d_tpu_torch.dense.mesh import extract_mesh
    from recon3d_tpu_torch.dense.tsdf import TSDFVolume
    from tests.test_tsdf_mesh import _sphere_volume

    return extract_mesh(TSDFVolume(*_sphere_volume(n=n)))


def test_mesh_shaded_rendering(tmp_path):
    from recon3d_tpu_torch.gui.viewer import is_mesh_ply, mesh_to_shaded_points
    from recon3d_tpu_torch.io.ply import save_mesh_ply

    verts, faces = _sphere_mesh(32)
    mp = tmp_path / "mesh.ply"
    save_mesh_ply(str(mp), verts, faces, np.full((len(verts), 3), 200, np.uint8))
    pp = tmp_path / "pts.ply"
    save_ply(str(pp), verts)
    assert is_mesh_ply(str(mp)) and not is_mesh_ply(str(pp))
    assert jviewer.is_mesh_ply(str(mp)) and not jviewer.is_mesh_ply(str(tmp_path / "none.ply"))

    pts, cols = mesh_to_shaded_points(verts, faces, np.full((len(verts), 3), 200, np.uint8),
                                      samples=20000)
    assert pts.shape == (20000, 3) and cols.shape == (20000, 3)
    rad = np.linalg.norm(pts, axis=1)
    assert np.abs(rad - 0.8).max() < 0.1
    assert cols.max() - cols.min() > 60
    ref_p, ref_c = jviewer.mesh_to_shaded_points(
        verts, faces, np.full((len(verts), 3), 200, np.uint8), samples=20000)
    np.testing.assert_array_equal(pts, ref_p)
    np.testing.assert_array_equal(cols, ref_c)

    paths = render_turntable(str(mp), str(tmp_path / "m"), n_frames=2, image_size=(80, 100))
    from PIL import Image

    img = np.asarray(Image.open(paths[0]))
    lit = (img.max(axis=-1) > 40).mean()
    assert lit > 0.15
    ref = jviewer.render_turntable(str(mp), str(tmp_path / "j"), n_frames=2,
                                   image_size=(80, 100))
    np.testing.assert_array_equal(img, np.asarray(Image.open(ref[0])))


def test_zbuffer_nearest_wins():
    rng = np.random.default_rng(1)
    near = rng.normal(scale=0.2, size=(500, 3)).astype(np.float32)
    far = near * 3.0
    pts = np.concatenate([far, near])
    cols = np.concatenate([np.full((500, 3), 255, np.uint8), np.zeros((500, 3), np.uint8)])
    img = render_pointcloud(pts, cols, image_size=(100, 120), point_size=2)
    c = img[40:60, 50:70]
    assert (c.max(axis=-1) < 100).sum() > (c.min(axis=-1) > 150).sum()


def test_interactive_cloud_lod():
    from recon3d_tpu_torch.gui.viewer import LOD_DRAG_POINTS, InteractiveCloud

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(250_000, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (250_000, 3), dtype=np.uint8)
    cloud = InteractiveCloud(pts, cols)
    full_p, _ = cloud.for_display(interacting=False)
    assert len(full_p) == 250_000
    lod_p, lod_c = cloud.for_display(interacting=True)
    assert len(lod_p) == LOD_DRAG_POINTS and len(lod_c) == LOD_DRAG_POINTS
    lod_p2, _ = cloud.for_display(interacting=True)
    assert lod_p2 is lod_p
    half_p, _ = cloud.for_display(interacting=True, frac=0.5)
    assert len(half_p) == LOD_DRAG_POINTS // 2
    small = InteractiveCloud(pts[:1000], cols[:1000])
    sp, _ = small.for_display(interacting=True)
    assert sp is small.points
    # the JAX copy's frames, bit for bit
    ref = jviewer.InteractiveCloud(pts, cols)
    np.testing.assert_array_equal(cloud.center, ref.center)
    assert cloud.radius == ref.radius
    for interacting, frac in ((True, 1.0), (True, 0.3), (False, 1.0)):
        kw = dict(center=cloud.center, radius=cloud.radius, azimuth_deg=40.0)
        np.testing.assert_array_equal(
            render_pointcloud(*cloud.for_display(interacting, frac), (60, 80), **kw),
            jviewer.render_pointcloud(*ref.for_display(interacting, frac), (60, 80), **kw))


def test_mesh_surface_samples_reshade_consistency():
    from recon3d_tpu_torch.gui.viewer import MeshSurfaceSamples, mesh_to_shaded_points

    verts, faces = _sphere_mesh(24)
    vcols = np.full((len(verts), 3), 180, np.uint8)
    samples = MeshSurfaceSamples(verts, faces, vcols, samples=5000, seed=3)
    p1, c1 = samples.shaded(30.0, 20.0)
    p_ref, c_ref = mesh_to_shaded_points(verts, faces, vcols, azimuth_deg=30.0,
                                         elevation_deg=20.0, samples=5000, seed=3)
    np.testing.assert_array_equal(p1, p_ref)
    np.testing.assert_array_equal(c1, c_ref)
    p2, c2 = samples.shaded(120.0, 20.0)
    assert p2 is p1 or np.shares_memory(p2, p1)
    assert not np.array_equal(c1, c2)
    p3, c3 = samples.shaded(30.0, 20.0, limit=1000)
    assert len(p3) == 1000
    np.testing.assert_array_equal(p3, p1[:1000])
    jp, jc = jviewer.MeshSurfaceSamples(verts, faces, vcols, samples=5000, seed=3).shaded(
        120.0, 20.0)
    np.testing.assert_array_equal(p2, jp)
    np.testing.assert_array_equal(c2, jc)
    flat = MeshSurfaceSamples(verts, faces[:0], None)
    np.testing.assert_array_equal(flat.shaded()[1],
                                  jviewer.MeshSurfaceSamples(verts, faces[:0], None).shaded()[1])


@pytest.mark.slow
def test_drag_render_under_budget():
    """Interactive orbit at the 1M-point display cap stays under the 50 ms
    redraw budget via the LOD path."""
    from recon3d_tpu_torch.gui.viewer import drag_render_benchmark

    r = drag_render_benchmark(n_points=1_000_000, frames=5)
    assert r["drag_ms"] < 50.0, f"drag redraw {r['drag_ms']:.1f} ms"
    assert r["full_ms"] < 2000.0


def test_modules_import_without_qt_or_jax():
    import subprocess

    probe = ("import sys; import recon3d_tpu_torch.gui.app, recon3d_tpu_torch.gui.viewer, "
             "recon3d_tpu_torch.tools.run_colmap, recon3d_tpu_torch.runtime.worker; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'recon3d_tpu', 'PyQt5')))")
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", probe], cwd=str(repo), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
