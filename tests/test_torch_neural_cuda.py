"""The neural front end on the card against the same code on the CPU.

SuperPoint's descriptors are sampled through K1 on the card and through
its plain version on the CPU; LightGlue runs at full width (9 layers, dim
256, 4 heads) with the bundled checkpoint. Every test here is marked
`cuda` and skips without a GPU. The file imports neither jax nor the JAX
package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_neural_cuda.py
"""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.config import NeuralConfig
from recon3d_tpu_torch.kernels import warp
from recon3d_tpu_torch.neural.lightglue import normalize_keypoints
from recon3d_tpu_torch.neural.matcher import NeuralMatcher
from recon3d_tpu_torch.neural.superpoint import NeuralFeatures
from tests.render import render_views

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (compares the card with the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gray(n=2, size=(240, 320)):
    scene = render_views(n_views=n, image_size=size, arc_step=0.1)
    return scene["images"] @ np.array([0.299, 0.587, 0.114], np.float32)


def test_superpoint_features_on_the_card_match_the_cpu(cuda_device):
    """The bundled SuperPoint on a 240x320 image at the default capacity:
    K1 launched once (256 descriptor planes sharing the keypoints), the
    plain version never; the valid keypoints within 0.05 px of the CPU's
    in 98% of the slots and their descriptors at cosine >= 0.999."""
    img = _gray(1)[0]
    cpu = NeuralMatcher(NeuralConfig(), device="cpu").extract(img)
    warp.counts.reset()
    card = NeuralMatcher(NeuralConfig(), device="cuda").extract(img)
    torch.cuda.synchronize()
    assert warp.counts.kernel == 1 and warp.counts.plain == 0
    assert dict(warp.counts.by_shape) == {"256x30x40/1x2048": 1}
    v = cpu.valid.numpy()
    assert 100 < v.sum() and abs(int(card.valid.sum()) - int(v.sum())) <= 2
    same = np.linalg.norm(card.xy.cpu().numpy() - cpu.xy.numpy(), axis=1) < 0.05
    assert (same & v).sum() >= 0.98 * v.sum()
    both = same & v & card.valid.cpu().numpy()
    cos = (card.desc.cpu().numpy()[both] * cpu.desc.numpy()[both]).sum(-1)
    assert (cos >= 0.999).mean() >= 0.99


def test_lightglue_full_width_on_the_card_matches_the_cpu(cuda_device):
    """The bundled LightGlue at full width on one pair of 1,024 keypoint
    slots: log-assignment within 2e-3 of its magnitude on the valid block,
    matchability within 1e-4, and the same mutual matches on 98% of rows."""
    cfg = NeuralConfig(matcher="lightglue", max_keypoints=1024)
    cpu_m = NeuralMatcher(cfg, device="cpu")
    card_m = NeuralMatcher(cfg, device="cuda")
    feats = [cpu_m.extract(g) for g in _gray(2)]
    hw = (240, 320)
    args = [feats[0].desc[None], feats[1].desc[None],
            normalize_keypoints(feats[0].xy[None], hw), normalize_keypoints(feats[1].xy[None], hw),
            feats[0].valid[None], feats[1].valid[None]]
    card_m._ensure_params()
    with torch.no_grad():
        la, m0, _ = cpu_m.lg(*args)
        lb, n0, _ = card_m.lg(*(a.cuda() for a in args))
    block = np.ix_(feats[0].valid.numpy(), feats[1].valid.numpy())
    ref = la[0].numpy()[block]
    np.testing.assert_allclose(lb[0].cpu().numpy()[block], ref, atol=2e-3 * np.abs(ref).max())
    np.testing.assert_allclose(n0.cpu().numpy(), m0.numpy(), atol=1e-4)
    on_card = [NeuralFeatures(**{k: getattr(f, k).cuda() for k in ("xy", "score", "desc", "valid")})
               for f in feats]
    a = card_m.match(*on_card, hw=hw)
    b = cpu_m.match(*feats, hw=hw)
    assert (a.idx2.cpu().numpy() == b.idx2.numpy()).mean() >= 0.98
    assert int(b.mask.sum()) >= 20
