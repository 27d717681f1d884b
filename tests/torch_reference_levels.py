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
    parts = set(sys.argv[1:]) or {"1", "2", "3", "4", "5", "6", "7"}
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
