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


def main():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    gate_levels("1. CLI test scene, 6 views of 128x160 at the CLI's settings",
                render_views(n_views=6, image_size=(128, 160), arc_step=0.15), range(4), 300)
    gate_levels("2. north-star scene, 50 views of 480x640 at the CLI's settings",
                render_views(n_views=50, image_size=(480, 640), arc_step=0.035,
                             arc_offset=0.035 * 49 / 2), range(2), 100)
    patchmatch_agreement()


if __name__ == "__main__":
    main()
