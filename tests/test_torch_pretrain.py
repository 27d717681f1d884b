"""The port's pretraining loops (recon3d_tpu_torch/neural/pretrain.py)
against the JAX package's (recon3d_tpu/neural/pretrain.py) on the CPU, end
to end at a small size, and the CLI.

Both packages' trainers print one line a round with its last step's
losses (and, for LightGlue, the ground-truth matches a pair); the tests
run both from the same starting parameters and compare those lines. The JAX LightGlue trainer
takes its depth from NeuralConfig's default (9 layers); both trainers are
run at 2 layers by giving each package's NeuralConfig that default for the
test.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import recon3d_tpu.config as jconfig
import recon3d_tpu_torch.config as tconfig
from recon3d_tpu.neural import pretrain as jpre
from recon3d_tpu.neural.lightglue import LightGlueNet as JaxLightGlue
from recon3d_tpu_torch.neural import pretrain as tpre
from recon3d_tpu_torch.neural import synthetic as tsyn
from recon3d_tpu_torch.neural.matcher import BUNDLED_SUPERPOINT

torch.set_num_threads(2)

HW = (64, 64)
LINE = re.compile(r"\[(pretrain[-\w]*)\] step (\d+)/\d+ loss ([\d.]+) \(\w+ ([\d.]+) \w+ "
                  r"([\d.]+)\)(?: gt-matches/pair (\d+))?")


def _rounds(text: str):
    return [(m[1], int(m[2]), *map(float, m.group(3, 4, 5)), m[6]) for m in LINE.finditer(text)]


def assert_same_rounds(got, ref):
    """Round by round: the same phase and step, the same ground-truth
    matches a pair, and the printed losses (4 decimals, a round's last step)
    within 5e-3 relative: after Adam's first update, which moves a
    parameter by about +-lr wherever its gradient is near zero and the
    frameworks' rounding picks the sign, the losses drift apart by a few
    parts in a thousand (tests/test_torch_train.py::assert_losses)."""
    assert len(got) == len(ref) > 0, (got, ref)
    for g, r in zip(got, ref):
        assert g[:2] == r[:2] and g[5] == r[5], (g, r)
        np.testing.assert_allclose(g[2:5], r[2:5], rtol=5e-3, atol=1e-4, err_msg=str((g, r)))


def _gradient_score(params, x):
    """A deterministic score map of each image (squared gradient magnitude,
    scaled to a maximum of 1), in numpy for both packages."""
    del params
    x = np.asarray(x)[..., 0].astype(np.float64)
    gy, gx = np.gradient(x, axis=(1, 2))
    s = gx * gx + gy * gy
    return (s / (s.max(axis=(1, 2), keepdims=True) + 1e-12)).astype(np.float32)


def test_pseudo_labels_identical_on_the_same_scores():
    """pseudo_label_images of both packages on the same score function: the
    same homographies drawn, the same corners in the same order."""
    r = np.random.default_rng(0)
    imgs = [tsyn.render_texture(r, HW) for _ in range(2)] + [tsyn.render_shapes(r, HW)[0]]
    ref = jpre.pseudo_label_images(_gradient_score, None, imgs, np.random.default_rng(5), HW,
                                   threshold=0.05)
    got = tpre.pseudo_label_images(_gradient_score, None, imgs, np.random.default_rng(5), HW,
                                   threshold=0.05)
    assert [len(c) for c in got] == [len(c) for c in ref] and sum(map(len, ref)) > 20
    for g, c in zip(got, ref):
        np.testing.assert_array_equal(g, c)


def test_train_matches_jax_end_to_end(capsys, tmp_path):
    """train() at 64x64, batch 8, from the bundled checkpoint (init_weights):
    one round of 2 batches x 2 epochs on shapes, then one round of
    homographic adaptation drawing scene renders and textures (pseudo-
    labelled by the network being trained). Each round's printed losses
    as assert_same_rounds holds them; the written .npz loads into the
    port."""
    kw = dict(steps=4, batch=8, hw=HW, lr=1e-3, seed=0, batches_per_round=2,
              epochs_per_round=2, adapt_steps=4, texture_frac=0.5, scene_frac=0.5,
              init_weights=str(BUNDLED_SUPERPOINT))
    jpre.train(**kw)
    ref = _rounds(capsys.readouterr().out)
    stats = {}
    out = tmp_path / "sp.npz"
    state = tpre.train(**kw, out=str(out), device="cpu", stats=stats)
    got = _rounds(capsys.readouterr().out)
    assert [r[0] for r in ref] == ["pretrain", "pretrain-adapt"]
    assert_same_rounds(got, ref)
    assert state.step == 8 and [r["phase"] for r in stats["rounds"]] == ["shapes", "adapt"]
    assert all(np.isfinite(r["losses"]).all() for r in stats["rounds"])
    from recon3d_tpu_torch.convert import load_params_npz
    from recon3d_tpu_torch.neural.superpoint import SuperPointNet

    load_params_npz(out, SuperPointNet())


def test_train_lightglue_matches_jax_end_to_end(capsys, monkeypatch):
    """train_lightglue() at 2 layers (full width 256, 4 heads), 64x64, 32
    keypoints, batches of 8 pairs, two rounds of 2 batches x 2 epochs, half
    the pairs true 3-D view pairs and half of the rest textures, the frozen
    bundled SuperPoint, from the JAX initialisation passed in: each round's
    ground-truth matches a pair and its printed losses as
    assert_same_rounds holds them."""
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "NeuralConfig",
                            functools.partial(mod.NeuralConfig, lightglue_layers=2))
    K = 32
    init = JaxLightGlue(dim=256, num_layers=2).init(
        jax.random.PRNGKey(0), jnp.zeros((K, 256)), jnp.zeros((K, 256)), jnp.zeros((K, 2)),
        jnp.zeros((K, 2)), jnp.ones(K, bool), jnp.ones(K, bool))
    init = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]}
    kw = dict(steps=8, batch=8, hw=HW, max_keypoints=K, lr=1e-3, seed=0,
              batches_per_round=2, epochs_per_round=2, texture_frac=0.5, view_pair_frac=0.5)
    jpre.train_lightglue(**kw)
    ref = _rounds(capsys.readouterr().out)
    stats = {}
    state = tpre.train_lightglue(**kw, device="cpu", init_params=init, stats=stats)
    got = _rounds(capsys.readouterr().out)
    assert [r[1] for r in ref] == [4, 8]
    assert_same_rounds(got, ref)
    assert state.step == 8 and state.module.num_layers == 2
    assert all(r["gt_matches_per_pair"] > 0 for r in stats["rounds"])


def test_pretrain_cli_writes_only_its_out(tmp_path, capsys):
    """The CLI on the CPU: --model lightglue renames the default output and
    caps the batch at 16; --out inside the JAX package's bundled directory
    is refused; --stats-json records the rounds and K1's calls (the plain
    version on the CPU); the written LightGlue loads into NeuralMatcher."""
    import json

    parser = tpre.build_parser()
    assert parser.parse_args([]).out.endswith(
        "recon3d_tpu_torch/neural/pretrained/superpoint_synthetic.npz")
    with pytest.raises(ValueError, match="bundled"):
        tpre.train(steps=0, out=str(BUNDLED_SUPERPOINT), device="cpu")
    out = tmp_path / "superpoint_synthetic.npz"
    stats = tmp_path / "stats.json"
    assert tpre.main(["--model", "lightglue", "--steps", "2", "--batch", "2", "--size", "64",
                      "--batches-per-round", "1", "--epochs-per-round", "2", "--device", "cpu",
                      "--out", str(out), "--stats-json", str(stats)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["lightglue_synthetic.npz",
                                                         "stats.json"]
    st = json.loads(stats.read_text())
    k1 = st["k1_calls_by_stage"]["train_lightglue"]
    assert k1["kernel"] == 0 and k1["plain"] == 4    # 2 pairs: 4 images, one call each
    assert len(st["rounds"]) == 1 and st["peak_bytes"] is None
    assert "[pretrain-lg] step 2/2" in capsys.readouterr().out
    from recon3d_tpu_torch.neural.matcher import NeuralMatcher

    m = NeuralMatcher(tconfig.NeuralConfig(lightglue_weights=str(
        tmp_path / "lightglue_synthetic.npz")), device="cpu")
    m._ensure_params()
    assert m.matcher_kind == "lightglue"
