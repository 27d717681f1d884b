"""Where the JAX reference itself lands on the gates the port is held to.

Not a test: prints the numbers behind the bounds that
tests/test_torch_cli.py, tests/test_torch_patchmatch.py and chip_smoke.py
state. Runs on the CPU in a few minutes:

    JAX_PLATFORMS=cpu python tests/torch_reference_levels.py

1. The CLI test's scene (6 views of 128x160, PatchMatchConfig defaults,
   so 32x40 working maps): surface gate of the JAX and the port's
   PatchMatchMVS for seeds 0-3.
2. The north-star scene of chip_smoke.py (50 views of 480x640 at the CLI's
   settings, so 120x160 working maps): the same, seeds 0-1.
3. patchmatch_depth on tests/test_torch_patchmatch.py's scene: the share of
   pixels within each relative-depth bound of the JAX run, for the port
   given the JAX draws and for the JAX rerun on images scaled by 1 + 2^-22.
4. The SfM front end (load, extract_features, match_image_pairs of the JAX
   SfMPipeline at its default configuration) on the north-star scene's 50
   PNGs: the ground-truth gate of chip_smoke.py's sfm_front phase
   (tests/torch_scene.match_graph_levels). About a quarter of an hour.
5. SIFT on tests/test_torch_sift.py's image: the JAX extractor's agreement
   with itself on the image scaled by 1 + 2^-22, the level that test holds
   the port to.
6. The whole sparse reconstruction (SfMPipeline.reconstruct of the JAX
   package at its default configuration) on the same 50 PNGs: cameras,
   points, reprojection error, waves, full-BA calls and the
   similarity-aligned pose errors against the scene's true poses
   (tests/torch_scene.pose_errors): the level that sets the gate of
   chip_smoke.py's sfm_sparse phase. With `6 port` the port's pipeline
   runs on the CPU on the same images beside it.
7. The 5-point solver on 512 exact samples: for how many of them the true
   E is among the valid candidates (to 1e-4 ... 1e-1 of its unit norm), for
   the JAX function, the port, and the port given the eigenvectors of the
   null-space projector as its basis instead of the Householder QR's.
8. The JAX CLI's main path, `images --mvs --mesh --calibration K`, on the
   north-star PNGs: cameras, reprojection error and pose errors, the dense
   cloud taken into the scene's frame by the SfM cameras
   (tests/torch_scene.to_scene_frame) on the surface gate, and the mesh:
   the level of chip_smoke.py's cli_images phase. About 10 minutes.
9. The JAX CLI's `--stereo --mesh --from-colmap` on the same PNGs with the
   COLMAP model of the true poses that chip_smoke.py writes: the surface
   gate of dense_stereo.ply and the mesh, the level of its stereo run.
10. The rescue pass: the JAX SfMPipeline on the first 20 views of the
   50-view parity arc (scripts/parity_run.py: arc step 0.06, views 0-9
   edge-on), seeds 0-7: which views the rescue pass wins back, the level
   of chip_smoke.py's rescue phase. With `10 port` the port runs beside it
   on the CPU. About 2 minutes a seed.
11. The plane sweep on tests/test_torch_plane_sweep.py's scene: the share
   of confident pixels within each relative-depth bound of the JAX sweep,
   for the port and for the JAX sweep on images scaled by 1 + 2^-22, and
   how far one plane's windowed NCC moves between the JAX and the port
   warp of the same source (the float32 rounding of the homography).
12. Dense SIFT: the JAX CLI's `--dense --from-colmap` with the COLMAP model
   of the true poses on the north-star PNGs, its first 16 views (`12 full`:
   all 50): dense.ply on the surface gate, its size and the stage time.
   `12 full model=DIR` takes the COLMAP model in DIR instead (the port's
   SfM cameras, as chip_smoke.py's dense_sift phase uses them) and carries
   the cloud into the scene's frame (tests/torch_scene.to_scene_frame): the
   level of that phase. `12 port` runs the port's CLI on the CPU beside it.

13. Global SfM: the JAX CLI's `images --global-sfm --mvs --calibration K`
   on the north-star PNGs: cameras, reprojection error and the
   similarity-aligned pose errors (tests/torch_scene.pose_errors), and the
   dense cloud in the scene's frame on the surface gate: the level of
   chip_smoke.py's global_sfm phase. `13 port` runs the port's CLI on the
   CPU beside it. About 10 minutes.
14. The neural front end: the JAX CLI's `images --neural --mvs
   --calibration K` on the same PNGs (SuperPoint at the default
   NeuralConfig: 2,048 keypoints, the `nn` matcher): the same measures, the
   level of chip_smoke.py's neural CLI run. `14 port` adds the port.
15. LightGlue: the JAX SfMPipeline(neural_mode=True) with
   matcher="lightglue" (the bundled checkpoint at full width) on the first
   12 north-star PNGs with the scene's K: cameras, reprojection error, pose
   errors, pairs kept: the level of chip_smoke.py's LightGlue run. `15 port`
   adds the port on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_reference_levels.py 4 5   # parts 4 and 5 only
"""

from __future__ import annotations

import contextlib
import io
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

from recon3d_tpu.camera import Camera as JaxCamera  # noqa: E402
from recon3d_tpu.config import PatchMatchConfig as JaxConfig  # noqa: E402
from recon3d_tpu.dense.patchmatch import PatchMatchMVS as JaxMVS  # noqa: E402
from recon3d_tpu_torch.camera import Camera  # noqa: E402
from recon3d_tpu_torch.config import PatchMatchConfig  # noqa: E402
from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS  # noqa: E402
from tests.render import render_views  # noqa: E402
from tests.torch_scene import sparse_from_depth, surface_gate  # noqa: E402


def gate_levels(title, scene, seeds, per_view):
    n = len(scene["Rs"])
    images = (scene["images"] * 255).astype(np.uint8).astype(np.float32) / 255
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(n)}
    sparse = sparse_from_depth(scene, per_view=per_view)
    print(title)
    for seed in seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            pj, _ = JaxMVS(JaxCamera.from_matrix(scene["K"]), JaxConfig(seed=seed)
                           ).reconstruct(images, poses, sparse_points=sparse)
            pt, _ = PatchMatchMVS(Camera.from_matrix(scene["K"]),
                                  PatchMatchConfig(seed=seed), device="cpu"
                                  ).reconstruct(images, poses, sparse_points=sparse)
        for name, pts in (("jax ", pj), ("port", pt)):
            med, share = surface_gate(pts)
            print(f"  seed {seed} {name}: {len(pts):7d} points, median {med:.4f}, "
                  f"share within 0.15 {share:.4f}")


def patchmatch_agreement():
    from tests.test_torch_patchmatch import _inputs, _run_jax, _run_port

    scene = render_views(n_views=5, image_size=(96, 128), arc_step=0.12)
    inputs = _inputs(scene)
    key = jax.random.PRNGKey(0)
    kw = dict(num_iterations=2, patch=7)
    jd = np.asarray(_run_jax(inputs, key, **kw).depth)
    pd = _run_port(inputs, key, **kw).depth.numpy()
    perturbed = list(inputs)
    for k in (0, 1):
        perturbed[k] = inputs[k] * np.float32(1 + 2 ** -22)
    jd2 = np.asarray(_run_jax(perturbed, key, **kw).depth)
    print("3. patchmatch_depth, share of pixels within a relative depth bound "
          "of the JAX run")
    for thr in (1e-6, 1e-3, 1e-2, 3e-2, 1e-1):
        print(f"  {thr:g}: port given the JAX draws {(np.abs(pd - jd) / jd < thr).mean():.4f}, "
              f"JAX on perturbed images {(np.abs(jd2 - jd) / jd < thr).mean():.4f}")


def sfm_front_levels():
    import json
    import tempfile
    import time

    from PIL import Image

    from recon3d_tpu.sfm.pipeline import SfMPipeline as JaxPipeline
    from tests.torch_scene import match_graph_levels

    scene = render_views(n_views=50, image_size=(480, 640), arc_step=0.035,
                         arc_offset=0.035 * 49 / 2)
    with tempfile.TemporaryDirectory() as tmp:
        for i, img in enumerate(scene["images"]):
            Image.fromarray((img * 255).astype(np.uint8)).save(f"{tmp}/view_{i:03d}.png")
        pipe = JaxPipeline()
        pipe.load_images(tmp)
    t0 = time.time()
    pipe.extract_features()
    t1 = time.time()
    pipe.match_image_pairs()
    t2 = time.time()
    levels = match_graph_levels(pipe.matches, pipe.kp_xy, scene,
                                len(pipe._components(50)))
    counts = pipe.stats["features_per_image"]
    print("4. SfM front end of the JAX package on the north-star scene (CPU: "
          f"extract {t1 - t0:.0f} s, match {t2 - t1:.0f} s host time)")
    print(f"  features per image: mean {np.mean(counts):.1f}, min {min(counts)}, "
          f"max {max(counts)}; capacity {pipe.kp_xy[0].shape[0]}")
    print("  " + json.dumps(levels))


def sfm_sparse_levels(with_port: bool):
    import json
    import tempfile
    import time

    from PIL import Image

    from recon3d_tpu.sfm.pipeline import SfMPipeline as JaxPipeline
    from tests.torch_scene import pose_errors

    scene = render_views(n_views=50, image_size=(480, 640), arc_step=0.035,
                         arc_offset=0.035 * 49 / 2)
    print("6. SfMPipeline.reconstruct() on the north-star scene, default configuration, "
          "the scene's K as calibration (CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        for i, img in enumerate(scene["images"]):
            Image.fromarray((img * 255).astype(np.uint8)).save(f"{tmp}/view_{i:03d}.png")
        calib = f"{tmp}/calibration.npz"
        np.savez(calib, mtx=np.asarray(scene["K"], np.float64), dist=np.zeros(5))
        runs = [("jax ", lambda: JaxPipeline(calibration_path=calib))]
        if with_port:
            from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

            runs.append(("port", lambda: SfMPipeline(calibration_path=calib, device="cpu")))
        for name, make in runs:
            pipe = make()
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                pipe.reconstruct(tmp)
            st = pipe.stats
            out = {
                "num_cameras": st["num_cameras"], "num_points": st["num_points"],
                "mean_reproj_px": round(float(st["mean_reproj_px"]), 4),
                "waves": st["register_detail_s"]["waves"],
                "ba_full_calls": st["ba_full_detail_s"]["calls"],
                "unregistered": sorted(set(range(50)) - set(pipe.registered)),
                **{k: round(v, 4) for k, v in pose_errors(pipe.poses, scene).items()},
                "host_seconds": round(time.time() - t0, 1),
            }
            print(f"  {name}: " + json.dumps(out), flush=True)


NORTH_STAR = dict(n_views=50, image_size=(480, 640), arc_step=0.035, arc_offset=0.035 * 49 / 2)


def _write_pngs(scene, img_dir: Path, names=None) -> list:
    from PIL import Image

    img_dir.mkdir(parents=True, exist_ok=True)
    names = names or [f"view_{i:03d}.png" for i in range(len(scene["images"]))]
    for name, img in zip(names, scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / name)
    return names


def cli_levels():
    import json
    import tempfile
    import time

    from recon3d_tpu.cli import main as jax_cli
    from recon3d_tpu.io.ply import load_mesh_ply, load_ply
    from tests.torch_scene import pose_errors, to_scene_frame

    scene = render_views(**NORTH_STAR)
    print("8. JAX CLI `images --mvs --mesh` on the north-star scene, the scene's K as "
          "calibration (CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_pngs(scene, tmp / "images")
        np.savez(tmp / "calibration.npz", mtx=np.asarray(scene["K"], np.float64),
                 dist=np.zeros(5))
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            jax_cli([str(tmp / "images"), "--mvs", "--mesh", "--calibration",
                     str(tmp / "calibration.npz"), "--output", str(tmp / "out"),
                     "--devices", "1", "--stats-json", str(tmp / "stats.json")])
        st = json.loads((tmp / "stats.json").read_text())
        p = np.load(tmp / "out" / "poses.npz")
        poses = {int(i): (R, t) for i, R, t in zip(p["image_ids"], p["Rs"], p["ts"])}
        dense, _ = load_ply(str(tmp / "out" / "dense_mvs.ply"))
        med, share = surface_gate(to_scene_frame(dense, poses, scene))
        verts, faces, _ = load_mesh_ply(str(tmp / "out" / "mesh.ply"))
        out = {"num_cameras": st["num_cameras"],
               "mean_reproj_px": round(float(st["mean_reproj_px"]), 4),
               **{k: round(v, 4) for k, v in pose_errors(poses, scene).items()},
               "dense_points": len(dense), "dense_median": round(med, 4),
               "dense_share": round(share, 4), "mesh_vertices": len(verts),
               "mesh_faces": len(faces),
               "stage_times_s": {k: round(v, 1) for k, v in st["stage_times_s"].items()},
               "host_seconds": round(time.time() - t0, 1)}
        print("  jax : " + json.dumps(out), flush=True)


def stereo_levels():
    import json
    import tempfile

    from recon3d_tpu.cli import main as jax_cli
    from recon3d_tpu.io.colmap import save_colmap_text
    from recon3d_tpu.io.ply import load_mesh_ply, load_ply

    scene = render_views(**NORTH_STAR)
    print("9. JAX CLI `--stereo --mesh --from-colmap` (true poses) on the north-star scene (CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        names = _write_pngs(scene, tmp / "images")
        poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(len(names))}
        save_colmap_text(str(tmp / "model"), scene["K"], NORTH_STAR["image_size"], poses,
                         sparse_from_depth(scene, per_view=100), None, names=names)
        with contextlib.redirect_stdout(io.StringIO()):
            jax_cli([str(tmp / "images"), "--stereo", "--mesh", "--from-colmap",
                     str(tmp / "model"), "--output", str(tmp / "out"), "--devices", "1"])
        pts, _ = load_ply(str(tmp / "out" / "dense_stereo.ply"))
        med, share = surface_gate(pts)
        verts, faces, _ = load_mesh_ply(str(tmp / "out" / "mesh.ply"))
        print("  jax : " + json.dumps({"stereo_points": len(pts), "median": round(med, 4),
                                      "share": round(share, 4), "mesh_vertices": len(verts),
                                      "mesh_faces": len(faces)}), flush=True)


def dense_sift_levels(n_views: int, model_dir=None, with_port: bool = False):
    import json
    import resource
    import tempfile
    import time

    from recon3d_tpu.cli import main as jax_cli
    from recon3d_tpu.io.colmap import save_colmap_text
    from recon3d_tpu.io.ply import load_ply
    from tests.torch_scene import to_scene_frame

    scene = render_views(**NORTH_STAR)
    print(f"12. JAX CLI `--dense --from-colmap` ({model_dir or 'true poses'}) on the first "
          f"{n_views} views of the north-star scene (CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        names = _write_pngs(scene, tmp / "images")
        poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(len(names))}
        save_colmap_text(str(tmp / "model"), scene["K"], NORTH_STAR["image_size"], poses,
                         sparse_from_depth(scene, per_view=100), None, names=names)
        from recon3d_tpu_torch.cli import main as port_cli

        argv = [str(tmp / "images"), "--dense", "--from-colmap", str(model_dir or tmp / "model"),
                "--max-images", str(n_views)]
        runs = [("jax ", jax_cli, ["--devices", "1"])]
        if with_port:
            runs.append(("port", port_cli, ["--device", "cpu"]))
        for name, cli, extra in runs:
            out = tmp / name.strip()
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                cli(argv + extra + ["--output", str(out), "--stats-json", str(out) + ".json"])
            st = json.loads(Path(str(out) + ".json").read_text())
            pts, _ = load_ply(str(out / "dense.ply"))
            if model_dir:
                p = np.load(out / "poses.npz")
                pts = to_scene_frame(pts, {int(i): (R, t) for i, R, t in
                                           zip(p["image_ids"], p["Rs"], p["ts"])}, scene)
            med, share = surface_gate(pts)
            print(f"  {name}: " + json.dumps({
                "views": n_views, "dense_points": len(pts), "median": round(med, 4),
                "share": round(share, 4),
                "stage_times_s": {k: round(v, 1) for k, v in st["stage_times_s"].items()},
                "host_seconds": round(time.time() - t0, 1),
                "max_rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)}),
                flush=True)


def cli_sfm_levels(part: str, flags, with_port: bool):
    """The JAX CLI `images <flags> --mvs --calibration K` on the north-star
    PNGs (and the port's CLI on the CPU beside it): the sparse result
    against the true poses and the dense cloud in the scene's frame."""
    import json
    import tempfile
    import time

    from recon3d_tpu.cli import main as jax_cli
    from recon3d_tpu_torch.cli import main as port_cli
    from recon3d_tpu_torch.io.ply import load_ply
    from tests.torch_scene import pose_errors, to_scene_frame

    scene = render_views(**NORTH_STAR)
    print(f"{part}. JAX CLI `images {' '.join(flags)} --mvs` on the north-star scene, the "
          "scene's K as calibration (CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_pngs(scene, tmp / "images")
        np.savez(tmp / "calibration.npz", mtx=np.asarray(scene["K"], np.float64),
                 dist=np.zeros(5))
        runs = [("jax ", jax_cli, ["--devices", "1"])]
        if with_port:
            runs.append(("port", port_cli, ["--device", "cpu"]))
        for name, cli, extra in runs:
            out = tmp / name.strip()
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                cli([str(tmp / "images"), *flags, "--mvs", "--calibration",
                     str(tmp / "calibration.npz"), "--output", str(out),
                     "--stats-json", str(out) + ".json", *extra])
            st = json.loads(Path(str(out) + ".json").read_text())
            p = np.load(out / "poses.npz")
            poses = {int(i): (R, t) for i, R, t in zip(p["image_ids"], p["Rs"], p["ts"])}
            dense, _ = load_ply(str(out / "dense_mvs.ply"))
            med, share = surface_gate(to_scene_frame(dense, poses, scene))
            print(f"  {name}: " + json.dumps({
                "num_cameras": st["num_cameras"], "num_points": st["num_points"],
                "mean_reproj_px": round(float(st["mean_reproj_px"]), 4),
                "num_pairs": st.get("num_pairs"),
                **{k: round(v, 4) for k, v in pose_errors(poses, scene).items()},
                "dense_points": len(dense), "dense_median": round(med, 4),
                "dense_share": round(share, 4),
                "stage_times_s": {k: round(v, 1) for k, v in st["stage_times_s"].items()},
                "host_seconds": round(time.time() - t0, 1)}), flush=True)


def lightglue_levels(with_port: bool, n_views: int = 12):
    import dataclasses
    import json
    import tempfile
    import time

    from recon3d_tpu.config import ReconstructionConfig as JaxRC
    from recon3d_tpu.sfm.pipeline import SfMPipeline as JaxPipeline
    from tests.torch_scene import pose_errors

    scene = render_views(**NORTH_STAR)
    print(f"15. SfMPipeline(neural_mode=True), matcher='lightglue' (bundled checkpoint), "
          f"on the first {n_views} north-star PNGs, the scene's K as calibration (CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        _write_pngs(scene, Path(tmp))
        calib = f"{tmp}/calibration.npz"
        np.savez(calib, mtx=np.asarray(scene["K"], np.float64), dist=np.zeros(5))
        runs = [("jax ", JaxPipeline, JaxRC)]
        if with_port:
            from recon3d_tpu_torch.config import ReconstructionConfig
            from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

            runs.append(("port", lambda **kw: SfMPipeline(device="cpu", **kw),
                         ReconstructionConfig))
        for name, make, rc in runs:
            cfg = rc()
            cfg = cfg.replace(neural=dataclasses.replace(cfg.neural, matcher="lightglue"))
            pipe = make(calibration_path=calib, neural_mode=True, config=cfg)
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                pipe.reconstruct(tmp, max_images=n_views)
            st = pipe.stats
            print(f"  {name}: " + json.dumps({
                "views": n_views, "num_cameras": st["num_cameras"],
                "num_points": st["num_points"],
                "mean_reproj_px": round(float(st["mean_reproj_px"]), 4),
                "num_pairs": st["num_pairs"],
                "unregistered": sorted(set(range(n_views)) - set(pipe.registered)),
                **{k: round(v, 4) for k, v in pose_errors(pipe.poses, scene).items()},
                "match_time": round(st["match_time"], 1),
                "host_seconds": round(time.time() - t0, 1)}), flush=True)


RESCUE_SCENE = dict(n_views=20, image_size=(480, 640), arc_step=0.06,
                    arc_offset=(19 / 2 - 49 / 2) * 0.06)


def rescue_levels(with_port: bool, seeds=range(8)):
    import dataclasses
    import json
    import tempfile

    from recon3d_tpu.config import ReconstructionConfig as JaxRC
    from recon3d_tpu.sfm.pipeline import SfMPipeline as JaxPipeline

    scene = render_views(**RESCUE_SCENE)
    print("10. the rescue pass on the first 20 views of the 50-view parity arc, "
          "the scene's K as calibration (CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        _write_pngs(scene, Path(tmp))
        calib = f"{tmp}/calibration.npz"
        np.savez(calib, mtx=np.asarray(scene["K"], np.float64), dist=np.zeros(5))
        runs = [("jax ", JaxPipeline, JaxRC)]
        if with_port:
            from recon3d_tpu_torch.config import ReconstructionConfig
            from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

            runs.append(("port", lambda **kw: SfMPipeline(device="cpu", **kw),
                         ReconstructionConfig))
        for name, make, rc in runs:
            for seed in seeds:
                cfg = rc()
                pipe = make(calibration_path=calib,
                            config=cfg.replace(sfm=dataclasses.replace(cfg.sfm, seed=seed)))
                found = {}
                rescue = pipe._rescue_unregistered

                def counted(rescue=rescue, pipe=pipe, found=found):
                    before = set(pipe.registered)
                    found["n"] = rescue()
                    found["views"] = sorted(set(pipe.registered) - before)
                    return found["n"]

                pipe._rescue_unregistered = counted
                with contextlib.redirect_stdout(io.StringIO()):
                    pipe.reconstruct(tmp)
                print(f"  {name} seed {seed}: " + json.dumps({
                    "rescued": found.get("n"), "rescued_views": found.get("views"),
                    "num_cameras": len(pipe.registered)}), flush=True)


def plane_sweep_agreement():
    import jax.numpy as jnp
    import torch

    from recon3d_tpu.dense import plane_sweep as jps
    from recon3d_tpu_torch.dense import plane_sweep as tps
    from tests.test_torch_plane_sweep import _agreement, _args

    scene = render_views(n_views=5, image_size=(96, 128), arc_step=0.1)
    args, _ = _args(scene)
    print("11. plane sweep: share of the pixels confident in both runs within a relative "
          "depth bound of the JAX sweep, and of equal counts")
    for hier in (True, False):
        kw = dict(num_depths=96, patch=5, ncc_threshold=0.7, min_views=3, hierarchical=hier)
        fn = jax.jit(jps.sweep_depth_map, static_argnames=tuple(kw))
        d_j, c_j, _ = (np.asarray(a) for a in fn(*(jnp.asarray(a) for a in args), **kw))
        scaled = list(args)
        scaled[0], scaled[1] = args[0] * np.float32(1 + 2 ** -22), args[1] * np.float32(1 + 2 ** -22)
        d_2, c_2, _ = (np.asarray(a) for a in fn(*(jnp.asarray(a) for a in scaled), **kw))
        d_t, c_t, _ = (a.numpy() for a in tps.sweep_depth_map(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw))
        for name, d, c in (("port given the same images", d_t, c_t),
                           ("JAX on images x (1 + 2^-22)", d_2, c_2)):
            rel, cnt = _agreement(d, c, d_j, c_j)
            print(f"  {'hierarchical' if hier else 'exhaustive  '} {name}: "
                  + ", ".join(f"{t:g}: {v:.4f}" for t, v in rel.items())
                  + f"; equal counts {cnt:.4f}")
    gray, K = args[0], jnp.asarray(args[2])
    src = jnp.asarray(args[1][1])
    Rr, tr = jps._relative_pose(*(jnp.asarray(a) for a in (args[3], args[4], args[5][1], args[6][1])))
    H, W = gray.shape
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
                          indexing="ij")
    grid = jnp.stack([xs, ys, jnp.ones_like(xs)], -1)

    @jax.jit
    def jax_plane(inv):
        w, ok = jps._warp_by_homography(src, jps.plane_homography(K, Rr, tr, inv), grid)
        return w, ok, jps._ncc(jnp.asarray(gray), w, ok, 5)

    Hp = tps.plane_homography(torch.from_numpy(args[2]), torch.from_numpy(np.asarray(Rr)),
                              torch.from_numpy(np.asarray(tr)), torch.tensor(0.25))
    wt, okt = tps._warp_by_homography(torch.from_numpy(args[1][1])[None], Hp[None, None],
                                      tps._pixel_grid_h(H, W, torch.float32, "cpu"))
    wj, okj, nj = (np.asarray(a) for a in jax_plane(jnp.float32(0.25)))
    from recon3d_tpu_torch.ops.ncc import ncc_windowed

    nt = ncc_windowed(torch.from_numpy(gray), wt[0, 0], okt[0, 0], 5).numpy()
    dn = np.abs(nt - nj)[okj & okt[0, 0].numpy()]
    print(f"  one plane (inverse depth 0.25), JAX and port warps of source 1: samples differ "
          f"by up to {np.abs(wt[0, 0].numpy() - wj).max():.2e}; windowed NCC by up to "
          f"{dn.max():.3f}, by more than 1e-3 on {(dn > 1e-3).mean():.4f} of the pixels")


def five_point_recovery():
    import jax.numpy as jnp
    import torch

    from recon3d_tpu.ops import essential5 as je5
    from recon3d_tpu_torch.ops import essential5 as te5
    from recon3d_tpu_torch.ops.linalg import eigh_batched
    from tests.test_torch_essential import _five_point_samples, _set_distance

    n = 512
    x1n, x2n, E_true = _five_point_samples(np.random.default_rng(7), n)

    def rates(E, ok):
        d = np.array([_set_distance(E_true[None], E[s][ok[s]]).min() if ok[s].any() else 9.0
                      for s in range(n)])
        return {f"{t:g}": round(float((d < t).mean()), 4) for t in (1e-4, 1e-3, 1e-2, 1e-1)}

    def projector_basis(Q):
        Qh = torch.linalg.qr(Q.transpose(-1, -2))[0]
        P = torch.eye(9) - Qh @ Qh.transpose(-1, -2)
        return eigh_batched(P)[1][..., :, 5:].transpose(-1, -2)

    print("7. 5-point solver: share of 512 exact samples whose true E is among the valid "
          "candidates, by distance")
    E, ok = jax.jit(jax.vmap(je5.nister_5point))(jnp.asarray(x1n), jnp.asarray(x2n))
    print("  jax                        :", rates(np.asarray(E), np.asarray(ok)))
    E, ok = te5.nister_5point(torch.from_numpy(x1n), torch.from_numpy(x2n))
    print("  port (Householder QR basis):", rates(E.numpy(), ok.numpy()))
    qr_basis, te5.null_space_rows = te5.null_space_rows, projector_basis
    try:
        E, ok = te5.nister_5point(torch.from_numpy(x1n), torch.from_numpy(x2n))
    finally:
        te5.null_space_rows = qr_basis
    print("  port (projector eigenbasis):", rates(E.numpy(), ok.numpy()))


def sift_self_agreement():
    from tests.test_torch_sift import sift_agreement_levels

    print("5. SIFT on the test image: JAX against JAX on the image scaled by 1 + 2^-22")
    print("  " + str(sift_agreement_levels()))


def main():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    parts = set(sys.argv[1:]) or {"1", "2", "3", "4", "5", "6", "7", "8", "9", "10", "11",
                                  "12", "13", "14", "15"}
    if "15" in parts:
        lightglue_levels("port" in parts)
    if "14" in parts:
        cli_sfm_levels("14", ["--neural"], "port" in parts)
    if "13" in parts:
        cli_sfm_levels("13", ["--global-sfm"], "port" in parts)
    if "12" in parts:
        model = next((a[len("model="):] for a in parts if a.startswith("model=")), None)
        dense_sift_levels(50 if "full" in parts else 16, model, "port" in parts)
    if "11" in parts:
        plane_sweep_agreement()
    if "10" in parts:
        rescue_levels("port" in parts)
    if "9" in parts:
        stereo_levels()
    if "8" in parts:
        cli_levels()
    if "7" in parts:
        five_point_recovery()
    if "6" in parts:
        sfm_sparse_levels("port" in parts)
    if "4" in parts:
        sfm_front_levels()
    if "5" in parts:
        sift_self_agreement()
    if "1" in parts:
        gate_levels("1. CLI test scene, 6 views of 128x160 at the CLI's settings",
                    render_views(n_views=6, image_size=(128, 160), arc_step=0.15), range(4), 300)
    if "2" in parts:
        gate_levels("2. north-star scene, 50 views of 480x640 at the CLI's settings",
                    render_views(n_views=50, image_size=(480, 640), arc_step=0.035,
                                 arc_offset=0.035 * 49 / 2), range(2), 100)
    if "3" in parts:
        patchmatch_agreement()


if __name__ == "__main__":
    main()
