"""The port's SuperPoint and LightGlue on the card against the plain
reference (benchmark/reference/superpoint_lightglue.py) at the published widths
and the benchmark cell's size: 1600x1200 images, 2,048 keypoint slots,
256-d descriptors, 9 LightGlue layers of 4 heads, the bundled checkpoints,
for one view and for one chunk of 8 pairs, through NeuralMatcher as the
SfM pipeline calls it.

The numbers and their limits are the cell dtu49_superpoint_lightglue.sfm's
own (benchmark/jobs/sfm_neural.py `network_numbers`, the limits of
benchmark/workloads/dtu49_superpoint_lightglue.sfm.json); the views are
rendered by benchmark/scene.py. The helpers come from `benchmark/`, never
from `tests.*`, whose name an installed package takes on a machine with a
card. Every test here is marked `cuda` and skips without a GPU; the file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -s tests/test_torch_neural_reference_cuda.py
"""

import json

import pytest
import torch

from benchmark import run as bench
from benchmark import scene as bench_scene
from benchmark.jobs import sfm_neural
from recon3d_tpu_torch.kernels import warp
from recon3d_tpu_torch.neural.matcher import NeuralMatcher
from recon3d_tpu_torch.runtime.device import disable_tf32

pytestmark = pytest.mark.cuda

CELL = "dtu49_superpoint_lightglue.sfm"
VIEWS = 9          # views 0-8: the first chunk's pairs (0, 1) ... (0, 8)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's networks at the cell's size on the card)")
    disable_tf32()
    files = bench.cell_files(CELL)
    config = dict(files["config"], views=VIEWS,
                  arc_span_rad=files["config"]["arc_span_rad"] * (VIEWS - 1)
                  / (files["config"]["views"] - 1))
    state = sfm_neural.setup(config, dict(files["traffic"], pool=1), 2**31 + 5, "cuda")
    images = state["pool"][0]["capture"]["images"]
    gray = images @ sfm_neural.GRAY
    matcher = NeuralMatcher(state["cfg"].neural, device="cuda")
    warp.counts.reset()
    feats = [matcher.extract(g) for g in gray]
    torch.cuda.synchronize()
    return {"state": state, "images": images, "gray": gray, "matcher": matcher, "feats": feats,
            "k1": dict(warp.counts.by_shape), "limits": files["cell"]["limits"]["numbers"]}


def _within(nums, limits):
    bad = {k: v for k, v in nums.items()
           if ("max" in limits[k] and v > limits[k]["max"])
           or ("min" in limits[k] and v < limits[k]["min"])}
    print(json.dumps({"numbers": nums, "outside": bad}))
    return not bad


def test_superpoint_at_1600x1200_matches_the_reference(card):
    """One view: 2,048 slots, K1 launched once a view at 256 planes of
    150x200 sharing 2,048 points; the probabilities, descriptors and the
    selection within the cell's limits."""
    f = card["feats"][0]
    assert f.xy.shape == (2048, 2) and f.desc.shape == (2048, 256)
    assert int(f.valid.sum()) > 1000
    assert card["k1"] == {"256x150x200/1x2048": VIEWS}
    net = {"hw": card["gray"].shape[1:3], "pairs": [],
           "views": [{"view": 0, "xy": f.xy, "score": f.score, "desc": f.desc,
                      "valid": f.valid}]}
    nums = sfm_neural.network_numbers(card["state"], net, card["images"])
    for name in ("lg_log_assign_err_max", "lg_match_agree", "lg_rows_compared"):
        nums.pop(name)
    assert _within(nums, card["limits"])


def test_a_chunk_of_lightglue_at_2048_slots_matches_the_reference(card):
    """One chunk of 8 pairs through match_pairs_batched with every pair
    named: each kept log-assignment, dustbins included, and LightGlue's
    matches within the cell's limits of the reference on the same
    features."""
    m, feats = card["matcher"], card["feats"]
    pairs = [(0, j) for j in range(1, VIEWS)]
    m.keep_assignment = pairs
    res = m.match_pairs_batched(feats, pairs, torch.Generator(device="cuda").manual_seed(0),
                                hw=card["gray"].shape[1:3])
    assert len(res) == 8 and sorted(m.kept_assignment) == pairs
    net = {"hw": card["gray"].shape[1:3], "views": [],
           "pairs": [{"pair": (i, j), "log_assign": m.kept_assignment[(i, j)],
                      "idx2": m.kept_matches[(i, j)],
                      "desc": (feats[i].desc, feats[j].desc), "xy": (feats[i].xy, feats[j].xy),
                      "valid": (feats[i].valid, feats[j].valid)} for i, j in pairs]}
    nums = sfm_neural.network_numbers(card["state"], net, card["images"])
    assert _within({k: nums[k] for k in ("lg_log_assign_err_max", "lg_match_agree")},
                   card["limits"])
    assert sum(int((m.kept_matches[p] >= 0).sum()) for p in pairs) > 0
    assert sum(r[5] for r in res) > 0
