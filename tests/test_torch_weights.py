"""The port's weights in both directions (recon3d_tpu_torch/neural/weights.py)
against the JAX package's (recon3d_tpu/neural/weights.py) on the CPU.

save_params_npz: a checkpoint the port writes loads into the JAX network
through its load_params_npz, and one JAX writes loads into the port; the
two forwards agree. The .pth converters mirror tests/test_weights.py:
public-layout state dicts (tests/torch_public_weights.py) convert to the
very Flax parameters the JAX converter builds, the port's networks give
the official blocks' forward, legacy names load, and partial or
mis-shaped files are refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.neural import weights as jw
from recon3d_tpu.neural.lightglue import LightGlueNet as JaxLightGlue
from recon3d_tpu.neural.superpoint import SuperPointNet as JaxSuperPoint
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.neural import weights as tw
from recon3d_tpu_torch.neural.lightglue import LightGlueNet
from recon3d_tpu_torch.neural.superpoint import SuperPointNet
from tests.torch_public_weights import (
    lightglue_reference,
    lightglue_state_dict,
    superpoint_reference,
    superpoint_state_dict,
)

torch.set_num_threads(2)

D, HEADS, LAYERS = 256, 4, 9


def flat_flax(params) -> dict:
    """A Flax parameter tree as '/'-keyed numpy arrays (the .npz keys)."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _lg_inputs(n0=48, n1=56, dim=D, seed=7):
    gen = torch.Generator().manual_seed(seed)
    desc0 = torch.nn.functional.normalize(torch.randn(n0, dim, generator=gen), dim=-1)
    desc1 = torch.nn.functional.normalize(torch.randn(n1, dim, generator=gen), dim=-1)
    xy0 = torch.rand(n0, 2, generator=gen) * 2 - 1
    xy1 = torch.rand(n1, 2, generator=gen) * 2 - 1
    return desc0, desc1, xy0, xy1


def _port_lg(net, desc0, desc1, xy0, xy1):
    with torch.no_grad():
        la, m0, m1 = net(desc0[None], desc1[None], xy0[None], xy1[None],
                         torch.ones(1, len(desc0), dtype=torch.bool),
                         torch.ones(1, len(desc1), dtype=torch.bool))
    return la[0].numpy(), m0[0].numpy(), m1[0].numpy()


def _jax_lg(net, params, desc0, desc1, xy0, xy1):
    la, m0, m1 = jax.jit(net.apply)(params, *(jnp.asarray(t.numpy()) for t in
                                              (desc0, desc1, xy0, xy1)),
                                    jnp.ones(len(desc0), bool), jnp.ones(len(desc1), bool))
    return np.asarray(la), np.asarray(m0), np.asarray(m1)


@pytest.fixture(scope="module")
def lg_file(tmp_path_factory):
    sd = lightglue_state_dict()
    path = tmp_path_factory.mktemp("w") / "lg.pth"
    torch.save(sd, path)
    net = JaxLightGlue(dim=D, num_heads=HEADS, num_layers=LAYERS)
    k = 32
    template = net.init(jax.random.PRNGKey(0), jnp.zeros((k, D)), jnp.zeros((k, D)),
                        jnp.zeros((k, 2)), jnp.zeros((k, 2)), jnp.ones(k, bool),
                        jnp.ones(k, bool))
    return sd, path, net, template


# -- save_params_npz both ways ------------------------------------------------------


@pytest.mark.parametrize("which", ["superpoint", "lightglue"])
def test_port_checkpoint_loads_into_jax(which, tmp_path):
    """The port's save_params_npz -> the JAX load_params_npz: exactly the
    keys of the JAX template, values the float16 of the port's, and the
    JAX forward on them equal to the port's forward on the same file
    (SuperPoint logits within 2e-4 of their range; LightGlue at 2 layers,
    dim 64, log-assignment within 1e-4 of its magnitude)."""
    gen = torch.Generator().manual_seed(3)
    path = tmp_path / "w.npz"
    if which == "superpoint":
        net, jnet = SuperPointNet(), JaxSuperPoint()
        template = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    else:
        net, jnet = LightGlueNet(dim=64, num_layers=2), JaxLightGlue(dim=64, num_layers=2)
        k = 8
        template = jnet.init(jax.random.PRNGKey(0), jnp.zeros((k, 64)), jnp.zeros((k, 64)),
                             jnp.zeros((k, 2)), jnp.zeros((k, 2)), jnp.ones(k, bool),
                             jnp.ones(k, bool))
    tw.flax_init_(net, gen)
    tw.save_params_npz(net, str(path))
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    assert set(stored) == set(flat_flax(template))
    assert all(v.dtype == np.float16 for v in stored.values())
    params = jw.load_params_npz(str(path), template)
    ours = tw.state_dict_to_flax(net)
    for key, v in flat_flax(params).items():
        np.testing.assert_array_equal(v, ours[key].astype(np.float16).astype(np.float32))
    reloaded = convert.load_params_npz(
        path, SuperPointNet() if which == "superpoint" else LightGlueNet(dim=64, num_layers=2))
    if which == "superpoint":
        img = np.random.default_rng(0).random((1, 64, 96, 1)).astype(np.float32)
        lj, dj = jax.jit(jnet.apply)(params, jnp.asarray(img))
        with torch.no_grad():
            lt, dt = reloaded(torch.from_numpy(img))
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), lj, atol=2e-4 * np.ptp(lj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4)
    else:
        args = _lg_inputs(12, 10, dim=64)
        la, m0, _ = _jax_lg(jnet, params, *args)
        lt, t0, _ = _port_lg(reloaded, *args)
        np.testing.assert_allclose(lt, la, atol=1e-4 * np.abs(la).max())
        np.testing.assert_allclose(t0, m0, atol=1e-5)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """The JAX save_params_npz -> the port's convert.load_params_npz: every
    parameter set from the file, SuperPoint's forward within 2e-4 of the
    JAX logits' range on the same file."""
    jnet = JaxSuperPoint()
    params = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 1)))
    path = tmp_path / "jax.npz"
    jw.save_params_npz(jax.device_get(params), str(path))
    loaded = jw.load_params_npz(str(path), params)
    net = convert.load_params_npz(path, SuperPointNet())
    ours = tw.state_dict_to_flax(net)
    for key, v in flat_flax(loaded).items():
        np.testing.assert_array_equal(ours[key], v)
    img = np.random.default_rng(1).random((2, 48, 64, 1)).astype(np.float32)
    lj, _ = jax.jit(jnet.apply)(loaded, jnp.asarray(img))
    with torch.no_grad():
        lt, _ = net(torch.from_numpy(img))
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, atol=2e-4 * np.ptp(lj))


# -- the .pth converters ---------------------------------------------------------------


def test_lightglue_pth_converts_as_jax_does(lg_file):
    """The port's conversion of a public LightGlue .pth is the JAX one, key
    for key and bit for bit (fused Wqkv split, rotary permutation, shared
    to_qk, identity input_proj, last assignment head)."""
    _, path, _, template = lg_file
    ref = flat_flax(jw.load_lightglue_torch(str(path), template, strict=True))
    got = tw.lightglue_flax_from_torch(path, LightGlueNet())
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_lightglue_conversion_forward_parity(lg_file):
    """The converted network against the official blocks' forward (tests/
    test_weights.py's tolerances: log-assignment 2e-3, matchability 1e-4)
    and against the JAX network on the JAX conversion (1e-4 of the
    log-assignment's magnitude)."""
    sd, path, jnet, template = lg_file
    net = tw.load_lightglue_torch(path, LightGlueNet(), strict=True)
    args = _lg_inputs()
    ref, r0, r1 = lightglue_reference(sd, *args)
    la, m0, m1 = _port_lg(net, *args)
    np.testing.assert_allclose(la, ref.numpy(), atol=2e-3)
    np.testing.assert_allclose(m0, r0.numpy(), atol=1e-4)
    np.testing.assert_allclose(m1, r1.numpy(), atol=1e-4)
    ja, _, _ = _jax_lg(jnet, jw.load_lightglue_torch(str(path), template), *args)
    np.testing.assert_allclose(la, ja, atol=1e-4 * np.abs(ja).max())


def test_lightglue_conversion_legacy_key_names(tmp_path):
    sd = lightglue_state_dict(legacy_names=True)
    path = tmp_path / "lg_legacy.pth"
    torch.save(sd, path)
    net = tw.load_lightglue_torch(path, LightGlueNet(), strict=True)
    np.testing.assert_array_equal(net.layer3.cross_attn0.to_v.weight.detach().numpy(),
                                  sd["cross_attn.3.to_v.weight"].numpy())
    # a "state_dict"-wrapped file unwraps
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pth")
    wrapped = tw.load_lightglue_torch(tmp_path / "wrapped.pth", LightGlueNet())
    for a, b in zip(net.parameters(), wrapped.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["missing", "badshape"])
def test_lightglue_strict_load_refuses_partial(case, tmp_path):
    """strict=True raises KeyError / ValueError naming the head; strict=False
    leaves the module's parameters as they were."""
    sd = lightglue_state_dict()
    if case == "missing":
        del sd["transformers.4.cross_attn.to_v.weight"]
        err, match = KeyError, "to_v"
    else:
        sd["log_assignment.8.final_proj.weight"] = torch.randn(D, D // 2)
        err, match = ValueError, "final_proj"
    path = tmp_path / f"{case}.pth"
    torch.save(sd, path)
    net = tw.flax_init_(LightGlueNet(), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with pytest.raises(err, match=match):
        tw.load_lightglue_torch(path, net, strict=True)
    tw.load_lightglue_torch(path, net, strict=False)
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_superpoint_pth_conversion(tmp_path):
    """SuperPoint: the conversion equals the JAX one bit for bit, the port's
    network gives the official forward (tests/test_weights.py's 1e-3) and,
    through convert and NeuralMatcher's loader, the forward of the same
    weights written as an .npz; a 'module.'-prefixed file is refused."""
    from recon3d_tpu_torch.config import NeuralConfig
    from recon3d_tpu_torch.neural.matcher import NeuralMatcher

    sd = superpoint_state_dict()
    path = tmp_path / "sp.pth"
    torch.save(sd, path)
    template = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    ref = flat_flax(jw.load_superpoint_torch(str(path), template))
    got = tw.superpoint_flax_from_torch(path, SuperPointNet())
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)

    img = torch.rand(64, 96, generator=torch.Generator().manual_seed(1))
    ref_logits, ref_desc = superpoint_reference(sd, img)
    net = convert.load_params_npz(path, SuperPointNet())
    with torch.no_grad():
        logits, desc = net(img[None, ..., None])
    np.testing.assert_allclose(logits[0].numpy(), ref_logits.numpy(), atol=1e-3)
    np.testing.assert_allclose(desc[0].numpy(), ref_desc.numpy(), atol=1e-3)

    tw.save_params_npz(net, str(tmp_path / "sp.npz"))
    feats = [NeuralMatcher(NeuralConfig(superpoint_weights=str(tmp_path / name),
                                        max_keypoints=64), device="cpu").extract(img.numpy())
             for name in ("sp.pth", "sp.npz")]
    for f in ("xy", "score", "desc", "valid"):
        assert torch.equal(getattr(feats[0], f), getattr(feats[1], f)), f

    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "dp.pth")
    with pytest.raises(KeyError, match="conv1a"):
        tw.load_superpoint_torch(tmp_path / "dp.pth", SuperPointNet())


# -- Flax's initialisation ---------------------------------------------------------------


@pytest.mark.parametrize("fan_in", [9, 576, 1152])
def test_init_follows_lecun_normal(fan_in):
    """flax_init_'s kernels against jax.nn.initializers.lecun_normal at the
    same fan-in: std 1/sqrt(fan_in) within 2% for both, every draw inside
    +-2 of the pre-scaling std (2 / 0.8796 / sqrt(fan_in)), and 9.2% of
    them beyond 1.5 of it (the truncated normal's tails) in both, within
    one point of each other."""
    lin = torch.nn.Linear(fan_in, 4096)
    tw.flax_init_(lin, torch.Generator().manual_seed(0))
    ours = lin.weight.detach().numpy().ravel()
    theirs = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0),
                                                           (fan_in, 4096))).ravel()
    sigma = fan_in ** -0.5
    bound = 2.0 * sigma / tw.TRUNCATED_NORMAL_STD
    for w in (ours, theirs):
        assert abs(w.std() / sigma - 1) < 0.02
        assert np.abs(w).max() <= bound * (1 + 1e-6)
        assert 0.08 < (np.abs(w) > 0.75 * bound).mean() < 0.105
    assert abs((np.abs(ours) > 0.75 * bound).mean()
               - (np.abs(theirs) > 0.75 * bound).mean()) < 0.01
    assert torch.count_nonzero(lin.bias) == 0


def test_init_of_the_networks_matches_flax_shapes_and_special_leaves():
    """Every parameter drawn: conv and dense kernels at std 1/sqrt(fan_in)
    (fan_in = in * kh * kw), biases zero, LayerNorm scales one, rotary
    frequencies standard normal; the same draw for the same seed."""
    a = tw.flax_init_(LightGlueNet(dim=64, num_layers=2), torch.Generator().manual_seed(5))
    b = tw.flax_init_(LightGlueNet(dim=64, num_layers=2), torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith(".bias"):
            assert not p.any()
        elif name.endswith("ln.weight"):
            assert (p == 1).all()
    sp = tw.flax_init_(SuperPointNet(), torch.Generator().manual_seed(6))
    w = sp.conv3b.weight.detach()
    assert abs(float(w.std()) * (128 * 9) ** 0.5 - 1) < 0.03
    assert float(a.rotary_freqs.detach().abs().max()) > 0
