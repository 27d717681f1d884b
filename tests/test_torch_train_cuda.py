"""The neural front end's training path on the card against the same code on
the CPU: one SuperPoint train step, one LightGlue train step at full width,
and train_lightglue's SuperPoint extraction, whose descriptor sampling is
K1 at the training shape (256 planes of 16x16 at 256 shared points). Every
test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_train_cuda.py
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

# An installed package named `tests` would win over this directory, which
# has no __init__.py: bind the name to it, as chip_smoke.py does, unless it
# is bound already.
_HERE = str(Path(__file__).resolve().parent)
if _HERE not in [str(Path(p).resolve()) for p in getattr(sys.modules.get("tests"), "__path__", [])]:
    sys.modules["tests"] = types.ModuleType("tests")
    sys.modules["tests"].__path__ = [_HERE]

from recon3d_tpu_torch.config import NeuralConfig  # noqa: E402
from recon3d_tpu_torch.kernels import warp  # noqa: E402
from recon3d_tpu_torch.neural import synthetic  # noqa: E402
from recon3d_tpu_torch.neural.matcher import NeuralMatcher  # noqa: E402
from recon3d_tpu_torch.neural.pretrain import extract_features, train_lightglue  # noqa: E402
from tests.torch_train_check import (  # noqa: E402
    GRAD_TOL,
    LOSS_RTOL,
    card_against_cpu,
    lightglue_step,
    superpoint_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (compares the card with the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("step,kw", [(superpoint_step, {}), (lightglue_step, {})],
                         ids=["superpoint_batch2_128", "lightglue_full_width_256kp"])
def test_train_step_on_the_card_matches_the_cpu(step, kw, cuda_device):
    """From the same parameters and batch: SuperPoint (batch 2 of 128x128)
    and LightGlue (9 layers, dim 256, 256 keypoints, 2 pairs) give losses
    within LOSS_RTOL and gradients within GRAD_TOL of the CPU's."""
    r = card_against_cpu(step, "cuda", **kw)
    assert r["finite"], r
    assert r["loss_rel_err"] < LOSS_RTOL, r
    assert r["grad_rel_err"] < GRAD_TOL, r


def test_k1_at_the_training_shape_in_train_lightglue(cuda_device):
    """train_lightglue's extraction of 2P = 8 images of 128x128 at 256
    keypoints: one K1 launch an image at 256x16x16 / 1x256, the plain
    version never; the card's valid keypoints within 0.05 px of the CPU's
    in 98% of the slots, descriptors at cosine >= 0.999 on 99% of those.
    Then one round of train_lightglue on the card: K1 launched at that
    shape only, finite losses."""
    cfg = NeuralConfig(max_keypoints=256, detection_threshold=2e-5)
    rng = np.random.default_rng(0)
    imgs = np.stack([synthetic.render_shapes(rng, (128, 128))[0] for _ in range(8)])
    cpu = NeuralMatcher(cfg, device="cpu")
    cpu._ensure_params()
    card = NeuralMatcher(cfg, device="cuda")
    card._ensure_params()
    ref = extract_features(cpu.sp, cfg, torch.from_numpy(imgs), 256)
    warp.counts.reset()
    got = extract_features(card.sp, cfg, torch.from_numpy(imgs).cuda(), 256)
    torch.cuda.synchronize()
    assert warp.counts.kernel == 8 and warp.counts.plain == 0
    assert dict(warp.counts.by_shape) == {"256x16x16/1x256": 8}
    v = ref.valid.numpy()
    assert v.sum() > 8 * 20
    same = np.linalg.norm(got.xy.cpu().numpy() - ref.xy.numpy(), axis=-1) < 0.05
    assert (same & v).sum() >= 0.98 * v.sum()
    both = same & v & got.valid.cpu().numpy()
    cos = (got.desc.cpu().numpy()[both] * ref.desc.numpy()[both]).sum(-1)
    assert (cos >= 0.999).mean() >= 0.99

    warp.counts.reset()
    stats = {}
    state = train_lightglue(steps=2, batch=2, batches_per_round=2, epochs_per_round=1,
                            device="cuda", stats=stats)
    torch.cuda.synchronize()
    assert warp.counts.plain == 0 and dict(warp.counts.by_shape) == {"256x16x16/1x256": 8}
    assert state.step == 2 and np.isfinite(stats["rounds"][0]["losses"]).all()


def test_k1_refuses_inputs_that_require_grad(cuda_device):
    """K1 has no backward: on the card, planes or points that require grad
    raise while grad mode is on; under no_grad the kernel runs."""
    planes = torch.rand(4, 16, 16, device="cuda", requires_grad=True)
    pts = torch.rand(1, 64, 2, device="cuda") * 15
    with pytest.raises(RuntimeError, match="no backward"):
        warp.tent_warp(planes, pts)
    with pytest.raises(RuntimeError, match="no backward"):
        warp.tent_warp(planes.detach(), pts.clone().requires_grad_())
    with torch.no_grad():
        out, _ = warp.tent_warp(planes, pts)
    ref, _ = warp.tent_warp_reference(planes.detach(), pts)
    assert torch.equal(out, ref)
