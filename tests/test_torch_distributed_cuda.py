"""The multi-device port on the card: parts (a) and (b) of chip_smoke.py's
multi_device phase (tests/torch_mesh_check.py) on the first 16 views of
the north-star scene at PatchMatch's working scale.

  (a) a world of 1 over NCCL: distributed_patchmatch, distributed_plane_
      sweep, the sharded TSDF and the sharded BA bit-identical to the
      functions on one device (one rank's shard is the batch);
  (b) a world of 2 sharing the one card over gloo (share_device=True): the
      same four within the JAX mesh tests' bounds (PatchMatch's on the
      north-star cut and on that test's scene), match_pairs_batched bit
      for bit, two make_pair_train_step steps (losses, the first step's
      gradients), and K1 launched on both ranks, its plain version never.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_distributed_cuda.py
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

_HERE = str(Path(__file__).resolve().parent)
if _HERE not in [str(Path(p).resolve()) for p in getattr(sys.modules.get("tests"), "__path__", [])]:
    sys.modules["tests"] = types.ModuleType("tests")
    sys.modules["tests"].__path__ = [_HERE]

from recon3d_tpu_torch.features.frontend import FeatureExtractor  # noqa: E402
from recon3d_tpu_torch.parallel import make_mesh  # noqa: E402
from tests import torch_mesh_check as check  # noqa: E402
from tests.render import render_views  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs the mesh's ranks on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # chip_smoke.py's north-star arc (50 views at 0.035 rad), its first 16
    return render_views(n_views=16, image_size=(480, 640), arc_step=0.035,
                        arc_offset=0.035 * 49 / 2.0)


def test_world_of_one_over_nccl_is_bit_identical(scene):
    inp = check.dense_inputs(scene, n_views=16, scale=0.25)
    with make_mesh(devices=1, device="cuda") as mesh:
        assert mesh.backend == "nccl" and mesh.world == 1
        dense = check.check_dense(mesh, inp, "cuda", exact=True)
        ba = check.check_ba(mesh, check.ba_problem(0), "cuda", exact=True)
    assert dense["tsdf_max_abs_err"] == 0.0 and ba["points_max_abs_err"] == 0.0


def test_world_of_two_sharing_the_card_over_gloo(scene):
    inp = check.dense_inputs(scene, n_views=16, scale=0.25)
    gray = np.stack([im.mean(-1) for im in scene["images"][:8]]).astype(np.float32)
    feats = FeatureExtractor(device="cuda").extract_batch(gray)
    pairs = [(i, j) for i in range(8) for j in range(i + 1, min(8, i + 4))]
    launches = {}
    with make_mesh(devices=2, device="cuda", share_device=True) as mesh:
        assert mesh.backend == "gloo" and mesh.world == 2
        check.check_dense(mesh, inp, "cuda", exact=False, launches=launches)
        check.check_patchmatch_bound(mesh, check.small_inputs(), "cuda")
        check.check_ba(mesh, check.ba_problem(0), "cuda", exact=False)
        check.check_matching(mesh, feats, pairs, "cuda")
        check.check_train_step(mesh, "cuda")
    for stage in ("patchmatch", "plane_sweep", "tsdf"):
        rec = launches[stage]
        assert all(r["kernel"] > 0 and r["plain"] == 0 for r in rec["by_rank"]), (stage, rec)
