"""LightGlue's attention kernel (csrc/attention.cu) on the card against its
plain version and against the plain version evaluated in float64.

Every test is marked `cuda` and skips without a GPU. The file imports
neither jax, the JAX package nor the repository's `tests` package, so it
runs as it is on a GPU machine:

    python -m pytest --noconftest -s tests/test_torch_lightglue_attention_cuda.py

The kernel's largest error against float64 may be at most twice the plain
float32 version's own: both compute in float32, in other orders.
"""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.config import NeuralConfig
from recon3d_tpu_torch.kernels import attention as attn
from recon3d_tpu_torch.neural import lightglue
from recon3d_tpu_torch.neural.lightglue import log_double_softmax, normalize_keypoints
from recon3d_tpu_torch.neural.matcher import NeuralMatcher
from recon3d_tpu_torch.neural.superpoint import NeuralFeatures
from recon3d_tpu_torch.runtime.profiling import span

pytestmark = pytest.mark.cuda

# attention calls a chunk of LightGlueNet at 9 layers: 2 self + 2 cross a layer
CALLS_A_CHUNK = 36


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the attention kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _heads(x, H):
    """(B, N, H * Dh) -> the (B, H, N, Dh) view Attention._heads gives."""
    B, N, D = x.shape
    return x.reshape(B, N, H, D // H).transpose(1, 2)


def _inputs(dev, B, H, Nq, Nk, Dh, seed, invalid_share=0.0, fused=False):
    """q, k, v as the projections leave them, (B, N, H * Dh) viewed per
    head (with `fused`, slices of one (B, N, 3 H Dh) tensor, rows 3 H Dh
    apart), and k_valid with `invalid_share` of the keys padded."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = H * Dh
    if fused:
        assert Nq == Nk
        qkv = torch.randn((B, Nq, 3 * D), generator=g, device=dev) * 2.0
        q, k, v = (_heads(qkv[..., i * D:(i + 1) * D], H) for i in range(3))
    else:
        q = _heads(torch.randn((B, Nq, D), generator=g, device=dev) * 2.0, H)
        k = _heads(torch.randn((B, Nk, D), generator=g, device=dev) * 2.0, H)
        v = _heads(torch.randn((B, Nk, D), generator=g, device=dev) * 2.0, H)
    valid = torch.rand((B, Nk), generator=g, device=dev) >= invalid_share
    return q, k, v, valid


def _errors(q, k, v, valid):
    """(kernel, plain float32, float64 reference) and the two float32 errors."""
    attn.counts.reset()
    got = attn.launch(q, k, v, valid)
    torch.cuda.synchronize()
    assert attn.counts.kernel == 1
    plain = attn.attention_plain(q, k, v, valid)
    exact = attn.attention_plain(q.double(), k.double(), v.double(), valid)
    err = (got.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    return got, plain, exact, err, err_plain


CASES = {
    "cell_self": dict(B=8, H=4, Nq=2048, Nk=2048, Dh=64),
    "cell_cross_padded": dict(B=8, H=4, Nq=2048, Nk=2048, Dh=64, invalid_share=0.3),
    "ragged_cross": dict(B=3, H=4, Nq=1000, Nk=1537, Dh=64, invalid_share=0.2),
    "dh32": dict(B=2, H=4, Nq=777, Nk=515, Dh=32, invalid_share=0.1),
    "dh128": dict(B=2, H=4, Nq=300, Nk=901, Dh=128, invalid_share=0.1),
    "fused_rows": dict(B=2, H=4, Nq=650, Nk=650, Dh=64, fused=True),
    "one_key": dict(B=2, H=4, Nq=70, Nk=1, Dh=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_within_twice_the_plain_error_of_float64(cuda_device, case):
    kw = dict(CASES[case])
    q, k, v, valid = _inputs(cuda_device, seed=sum(map(ord, case)), **kw)
    if case == "cell_cross_padded":
        valid[3] = False                                # a pair with every key invalid
    got, plain, exact, err, err_plain = _errors(q, k, v, valid)
    print(f"[attention {case}] kernel {err:.3e}, plain {err_plain:.3e} "
          f"against float64")
    assert got.shape == (kw["B"], kw["Nq"], kw["H"] * kw["Dh"])
    assert torch.isfinite(got).all()
    assert err <= 2.0 * err_plain + 1e-7
    if case == "cell_cross_padded":      # all keys invalid: the mean of every value
        mean = v[3].mean(dim=1).reshape(-1)           # (H, Dh) -> h * Dh + d
        assert torch.allclose(got[3], mean.expand_as(got[3]), atol=1e-5)


def test_launches_counted_and_refusals_raise(cuda_device):
    q, k, v, valid = _inputs(cuda_device, 2, 4, 64, 64, 64, seed=3)
    attn.counts.reset()
    with span("t.attention") as s:
        for _ in range(3):
            attn.attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert attn.counts.kernel == 3 and s.trace.counters == {"neural.attention_kernel": 3}
    for dtype in (torch.float64, torch.float16, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 only"):
            attn.attention(q.to(dtype), k.to(dtype), v.to(dtype), valid)
    for Dh in (16, 48, 256):
        x = torch.zeros((1, 2, 8, Dh), device=cuda_device)
        with pytest.raises(ValueError, match=f"head width {Dh}"):
            attn.attention(x, x, x, torch.ones((1, 8), dtype=torch.bool, device=cuda_device))
    assert attn.counts.kernel == 3
    # an input autograd would record: the kernel has no backward, so it raises
    qg = q.detach().requires_grad_(True)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        attn.attention(qg, k, v, valid)
    assert attn.counts.kernel == 3


def test_a_training_layer_takes_the_plain_version_and_an_eval_one_refuses_grad(cuda_device):
    """Attention in training mode computes its gradient through the plain
    version and launches nothing; the same layer in eval mode with
    parameters that require grad raises instead of dropping the gradient."""
    torch.manual_seed(4)
    layer = lightglue.Attention(256, 4).to(cuda_device)
    x = torch.randn((2, 300, 256), device=cuda_device)
    valid = torch.ones((2, 300), dtype=torch.bool, device=cuda_device)
    attn.counts.reset()
    layer(x, x, x, valid).square().sum().backward()
    assert attn.counts.kernel == 0
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in layer.parameters())
    layer.eval()
    with pytest.raises(RuntimeError, match="no backward"):
        layer(x, x, x, valid)
    with torch.no_grad():
        layer(x, x, x, valid)
    assert attn.counts.kernel == 1


def test_the_kernel_launches_on_the_inputs_card(cuda_device):
    """Inputs on a card other than the current one: the kernel runs there
    (its shared-memory attributes set on that card too) and agrees with the
    plain version there, and then again on the current card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    torch.cuda.set_device(0)
    for index in (1, 0):
        dev = torch.device("cuda", index)
        q, k, v, valid = _inputs(dev, 2, 4, 300, 517, 64, seed=5 + index, invalid_share=0.2)
        got, plain, exact, err, err_plain = _errors(q, k, v, valid)
        assert got.device == dev and torch.cuda.current_device() == 0
        assert err <= 2.0 * err_plain + 1e-7


def _matcher(dev):
    m = NeuralMatcher(NeuralConfig(matcher="lightglue"), device=dev)
    m._ensure_params()
    return m


def _features(n_views, N, dev, seed=0, hw=(1200, 1600)):
    rng = np.random.default_rng(seed)
    feats = []
    for _ in range(n_views):
        desc = rng.standard_normal((N, 256)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        xy = (rng.random((N, 2)) * np.array([hw[1], hw[0]])).astype(np.float32)
        valid = np.ones(N, bool)
        valid[rng.random(N) < 0.1] = False
        feats.append(NeuralFeatures(xy=torch.from_numpy(xy).to(dev),
                                    score=torch.ones(N, device=dev),
                                    desc=torch.from_numpy(desc).to(dev),
                                    valid=torch.from_numpy(valid).to(dev)))
    return feats


def test_match_pairs_batched_counts_36_launches_a_chunk(cuda_device):
    m = _matcher(cuda_device)
    feats = _features(5, 512, cuda_device)
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]     # 10 pairs: 2 chunks
    attn.counts.reset()
    with span("t.match") as s:
        m.match_pairs_batched(feats, pairs, torch.Generator(device=cuda_device).manual_seed(0),
                              chunk=8, hw=(1200, 1600))
    torch.cuda.synchronize()
    assert attn.counts.kernel == 2 * CALLS_A_CHUNK
    assert s.trace.counters["neural.attention_kernel"] == 2 * CALLS_A_CHUNK
    assert s.trace.counters["neural.lightglue_pairs"] == len(pairs)


def test_lightglue_scores_on_the_card_agree_with_the_plain_path(cuda_device, monkeypatch):
    """The bundled LightGlue at full width on 4 pairs of 2,048 slots: the
    log-assignment within the cell's limit (0.02) of the plain path's on
    valid entries, and each valid row's best column the same on 95% of rows."""
    m = _matcher(cuda_device)
    feats = _features(8, 2048, cuda_device, seed=1)
    hw = (1200, 1600)
    a, b = feats[:4], feats[4:]
    args = (torch.stack([f.desc for f in a]), torch.stack([f.desc for f in b]),
            normalize_keypoints(torch.stack([f.xy for f in a]), hw),
            normalize_keypoints(torch.stack([f.xy for f in b]), hw),
            torch.stack([f.valid for f in a]), torch.stack([f.valid for f in b]))
    attn.counts.reset()
    with torch.no_grad():
        z, m0, m1 = m.lg.scores(*args)
        assert attn.counts.kernel == CALLS_A_CHUNK
        monkeypatch.setattr(lightglue, "attention", attn.attention_plain)
        zp, m0p, m1p = m.lg.scores(*args)
    assert attn.counts.kernel == CALLS_A_CHUNK
    la, lap = log_double_softmax(z, m0, m1), log_double_softmax(zp, m0p, m1p)
    both = args[4][:, :, None] & args[5][:, None, :]
    err = (la - lap).abs()[both].max().item()
    agree = (la.argmax(-1) == lap.argmax(-1))[args[4]].float().mean().item()
    print(f"[lightglue scores] log-assignment {err:.3e} from the plain path, "
          f"argmax agreement {agree:.4f}, matchability {(m0 - m0p).abs().max().item():.3e}")
    assert err <= 0.02 and agree >= 0.95


def test_an_eval_scores_call_outside_no_grad_launches_the_kernel(cuda_device):
    """The matcher's nets ask for no gradient, so LightGlueNet.scores on the
    card launches the kernel 36 times a chunk even with grad mode on."""
    m = _matcher(cuda_device)
    feats = _features(4, 1024, cuda_device, seed=2)
    hw = (1200, 1600)
    a, b = feats[:2], feats[2:]
    args = (torch.stack([f.desc for f in a]), torch.stack([f.desc for f in b]),
            normalize_keypoints(torch.stack([f.xy for f in a]), hw),
            normalize_keypoints(torch.stack([f.xy for f in b]), hw),
            torch.stack([f.valid for f in a]), torch.stack([f.valid for f in b]))
    attn.counts.reset()
    assert torch.is_grad_enabled()
    z, m0, m1 = m.lg.scores(*args)
    torch.cuda.synchronize()
    assert attn.counts.kernel == CALLS_A_CHUNK
    assert not z.requires_grad and torch.isfinite(z).all()
