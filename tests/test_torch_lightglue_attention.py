"""LightGlue's attention dispatch (recon3d_tpu_torch/kernels/attention.py)
on the CPU: which inputs reach the kernel's launcher, the plain version
against the formula it replaced, and what the launcher refuses or passes
to the library before any device is touched. The kernel itself runs in
tests/test_torch_lightglue_attention_cuda.py."""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from recon3d_tpu_torch.config import NeuralConfig
from recon3d_tpu_torch.kernels import attention as attn
from recon3d_tpu_torch.neural import lightglue
from recon3d_tpu_torch.neural.lightglue import Attention, LightGlueNet
from recon3d_tpu_torch.neural.matcher import NeuralMatcher
from recon3d_tpu_torch.runtime.profiling import span


def _inline(q, k, v, k_valid, dim):
    """Attention.forward's formula before the dispatch, line for line."""
    Dh = q.shape[-1]
    att = torch.matmul(q, k.transpose(-1, -2)) / float(Dh) ** 0.5
    att = torch.where(k_valid[:, None, None, :], att, -1e9)
    out = torch.matmul(torch.softmax(att, dim=-1), v)
    B, _, N, _ = out.shape
    return out.transpose(1, 2).reshape(B, N, dim)


def _qkv(B=2, H=4, Nq=37, Nk=53, Dh=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, Nq, Dh), generator=g) * 3.0
    k = torch.randn((B, H, Nk, Dh), generator=g) * 3.0
    v = torch.randn((B, H, Nk, Dh), generator=g)
    valid = torch.rand((B, Nk), generator=g) > 0.3
    valid[1] = False                      # a pair whose keys are all invalid
    return q, k, v, valid


@pytest.fixture
def no_launch(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's launcher was reached")

    monkeypatch.setattr(attn, "launch", refuse)


@pytest.mark.parametrize("Nq,Nk,Dh", [(37, 53, 32), (64, 64, 64), (20, 7, 128), (1, 1, 16)])
def test_plain_equals_the_inline_formula_bit_for_bit(Nq, Nk, Dh):
    q, k, v, valid = _qkv(Nq=Nq, Nk=Nk, Dh=Dh)
    got = attn.attention_plain(q, k, v, valid)
    assert got.shape == (2, Nq, 4 * Dh)
    assert torch.equal(got, _inline(q, k, v, valid, 4 * Dh))
    # a pair with no valid key averages every value, as the plain softmax does
    assert torch.allclose(got[1].reshape(Nq, 4, Dh), v[1].mean(dim=1)[None], atol=1e-5)


def test_cpu_tensors_never_reach_the_launcher(no_launch):
    torch.manual_seed(0)
    layer = Attention(64, 2)
    x0, x1 = torch.randn((2, 19, 64)), torch.randn((2, 23, 64))
    valid = torch.rand((2, 23)) > 0.2
    with torch.no_grad():
        got = layer(x0, x1, x1, valid)
        q, k, v = (layer._heads(f(x)) for f, x in
                   ((layer.to_q, x0), (layer.to_k, x1), (layer.to_v, x1)))
        want = layer.to_out(_inline(q, k, v, valid, 64))
    assert torch.equal(got, want)


def test_lightglue_scores_on_the_cpu_never_reach_the_launcher(no_launch):
    torch.manual_seed(1)
    net = LightGlueNet(dim=64, num_heads=2, num_layers=2)
    B, N0, N1 = 2, 16, 12
    desc0, desc1 = torch.randn((B, N0, 64)), torch.randn((B, N1, 64))
    xy0, xy1 = torch.rand((B, N0, 2)) * 2 - 1, torch.rand((B, N1, 2)) * 2 - 1
    v0, v1 = torch.ones((B, N0), dtype=torch.bool), torch.rand((B, N1)) > 0.3
    with torch.no_grad():
        z, m0, m1 = net.scores(desc0, desc1, xy0, xy1, v0, v1)
    assert z.shape == (B, N0, N1) and torch.isfinite(m0).all() and torch.isfinite(m1).all()


def test_tensors_under_autograd_never_reach_the_launcher(no_launch):
    torch.manual_seed(2)
    layer = Attention(64, 2)
    x0 = torch.randn((1, 9, 64), requires_grad=True)
    valid = torch.ones((1, 9), dtype=torch.bool)
    layer(x0, x0, x0, valid).square().sum().backward()
    assert x0.grad is not None and torch.isfinite(x0.grad).all()
    assert all(p.grad is not None for p in layer.parameters())


@pytest.mark.parametrize("device,grad_mode,requires_grad,path", [
    ("cuda", False, False, "kernel"),
    ("cuda", False, True, "kernel"),       # no_grad: nothing to record
    ("cuda", True, False, "kernel"),       # no input asks for a gradient
    ("cuda", True, True, "raises"),        # autograd would record it: no backward
    ("cpu", False, False, "plain"),
    ("cpu", True, True, "plain"),
])
def test_the_dispatch_follows_device_and_gradient_state(monkeypatch, device, grad_mode,
                                                        requires_grad, path):
    taken = []
    monkeypatch.setattr(attn, "launch", lambda *a: taken.append("kernel"))
    monkeypatch.setattr(attn, "attention_plain", lambda *a: taken.append("plain"))
    t = SimpleNamespace(device=torch.device(device), requires_grad=requires_grad)
    other = SimpleNamespace(device=torch.device(device), requires_grad=False)
    with torch.set_grad_enabled(grad_mode):
        if path == "raises":
            with pytest.raises(RuntimeError, match="no backward"):
                attn.attention(other, t, other, None)
        else:
            attn.attention(other, t, other, None)
    assert taken == ([] if path == "raises" else [path])


@pytest.mark.parametrize("training,path", [(True, "plain"), (False, "dispatch")])
def test_the_layer_trains_on_the_plain_version(monkeypatch, training, path):
    """Attention in training mode calls attention_plain itself; in eval mode
    it goes through the dispatch, which picks the kernel on the card."""
    taken = []

    def record(name):
        def fn(q, k, v, k_valid):
            taken.append(name)
            return attn.attention_plain(q, k, v, k_valid)
        return fn

    monkeypatch.setattr(lightglue, "attention_plain", record("plain"))
    monkeypatch.setattr(lightglue, "attention", record("dispatch"))
    torch.manual_seed(3)
    layer = Attention(64, 2).train(training)
    x = torch.randn((1, 9, 64))
    layer(x, x, x, torch.ones((1, 9), dtype=torch.bool))
    assert taken == [path]


def test_the_matchers_nets_are_eval_mode_and_ask_for_no_gradient():
    """The matcher's nets are for inference: eval mode, so LightGlue's
    attention goes through the dispatch, and no parameter requires grad, so
    a call outside no_grad on the card still launches the kernel."""
    m = NeuralMatcher(NeuralConfig(), device="cpu")
    m._ensure_params()
    for net in (m.sp, m.lg):
        assert not net.training
        assert not any(p.requires_grad for p in net.parameters())


@pytest.mark.parametrize("change,message", [
    (dict(dtype=torch.float64), "float32 only"),
    (dict(dtype=torch.float16), "float32 only"),
    (dict(Dh=48), "head width 48"),
    (dict(Dh=16), "head width 16"),
    (dict(v_rows=5), "do not fit"),
    (dict(valid_dtype=torch.uint8), "bool tensor"),
    (dict(q_dims=3), r"\(B, H, N, Dh\)"),
    (dict(v_rows=0, k_rows=0, valid_cols=0), "empty input"),
    (dict(layout="strided"), "contiguous last axis"),
    (dict(layout="rows_off_16_bytes"), "16-byte boundaries"),
])
def test_launch_refuses_what_the_kernel_does_not_take(change, message):
    Dh = change.get("Dh", 64)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros((1, 2, 8, Dh)[4 - change.get("q_dims", 4):], dtype=dtype)
    k = torch.zeros((1, 2, change.get("k_rows", 9), Dh), dtype=dtype)
    v = torch.zeros((1, 2, change.get("v_rows", 9), Dh), dtype=dtype)
    valid = torch.ones((1, change.get("valid_cols", 9)), dtype=change.get("valid_dtype", torch.bool))
    if change.get("layout") == "strided":               # every second float of a row
        k = torch.zeros((1, 2, 9, 2 * Dh))[..., ::2]
    elif change.get("layout") == "rows_off_16_bytes":   # rows 65 floats apart
        k = torch.zeros((1, 2, 9, Dh + 1))[..., :Dh]
    with pytest.raises(ValueError, match=message):
        attn.launch(q, k, v, valid)


def test_launch_passes_the_strides_and_counts(monkeypatch):
    """With a stand-in library: q, k, v as the projections leave them
    ((B, N, H * Dh) viewed as (B, H, N, Dh)), the strides in floats, the
    output's (B, Nq, H * Dh) strides, the scale; one launch counted on the
    wrapper and in the trace."""
    calls = []

    def fake_launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(attn, "_library", lambda: SimpleNamespace(lg_attention_launch=fake_launch))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=7))
    entered = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: entered.append(device) or contextlib.nullcontext())
    B, H, Nq, Nk, Dh = 2, 4, 10, 12, 32
    q = torch.randn((B, Nq, H * Dh)).reshape(B, Nq, H, Dh).transpose(1, 2)
    k = torch.randn((B, Nk, H * Dh)).reshape(B, Nk, H, Dh).transpose(1, 2)
    v = torch.randn((B, H, Nk, Dh))
    valid = torch.ones((B, Nk), dtype=torch.bool)
    attn.counts.reset()
    with span("t.attention") as s:
        out = attn.launch(q, k, v, valid)
    assert out.shape == (B, Nq, H * Dh) and out.dtype == torch.float32
    (args,) = calls
    assert len(args) == 24
    assert args[5:10] == (B, H, Nq, Nk, Dh)
    assert args[10:19] == (Nq * H * Dh, Dh, H * Dh, Nk * H * Dh, Dh, H * Dh,
                           H * Nk * Dh, Nk * Dh, Dh)
    assert args[19:22] == (Nk, Nq * H * Dh, H * Dh)
    assert args[22] == pytest.approx(Dh ** -0.5) and args[23] == 7
    assert args[0] == q.data_ptr() and args[1] == k.data_ptr() and args[4] == out.data_ptr()
    assert entered == [q.device]          # launched on the inputs' device
    assert attn.counts.kernel == 1
    assert s.trace.counters == {"neural.attention_kernel": 1}


def test_launch_raises_on_a_failed_launch(monkeypatch):
    monkeypatch.setattr(attn, "_library",
                        lambda: SimpleNamespace(lg_attention_launch=lambda *a: 1))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    attn.counts.reset()
    q = torch.zeros((1, 1, 4, 32))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.launch(q, q, q, torch.ones((1, 4), dtype=torch.bool))
    assert attn.counts.kernel == 0
