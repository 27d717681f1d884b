"""The neural front end's training path of the port (recon3d_tpu_torch/neural:
synthetic, train, pretrain) against the JAX package's on the CPU.

The synthetic corpus is a copy, so one numpy seed gives identical arrays.
The losses, the optax pieces and the trainers take the same numpy inputs
and, for the trainers, the JAX initialisation carried across (flat Flax
parameters through convert.flax_to_state_dict): jax.random's draws cannot
be reproduced in torch. Convolutions and products sum in another order in
XLA and in PyTorch, and Adam's first step divides by |g| + 1e-8, so the
trainers are held to the losses step by step and to the gradients, each
with the tolerance stated beside it.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.config import MeshConfig
from recon3d_tpu.neural import synthetic as jsyn
from recon3d_tpu.neural import train as jtrain
from recon3d_tpu.neural.lightglue import LightGlueNet as JaxLightGlue
from recon3d_tpu.neural.superpoint import SuperPointNet as JaxSuperPoint
from recon3d_tpu.parallel.mesh import make_mesh
from recon3d_tpu_torch.convert import flax_to_state_dict
from recon3d_tpu_torch.neural import synthetic as tsyn
from recon3d_tpu_torch.neural import train as ttrain
from recon3d_tpu_torch.neural.lightglue import LightGlueNet
from recon3d_tpu_torch.neural.superpoint import SuperPointNet
from tests.torch_train_check import GRAD_TOL, grad_errors, lightglue_batch

torch.set_num_threads(2)

HW = (64, 64)


def flat_flax(params) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def assert_same(a, b, path="out"):
    """Equal nested outputs: arrays bit for bit, dicts and tuples leaf by leaf."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=path)


# -- the synthetic corpus ----------------------------------------------------------------


def _project(mod, r):
    sc = mod.render_view_pair(r, HW)
    xy = r.uniform(0, 63, (40, 2))
    return mod.project_view_points(xy, sc["depth_a"], sc["depth_b"], sc["K"], sc["Ra"],
                                   sc["ta"], sc["Rb"], sc["tb"])


def _warps(mod, r):
    img, cs = mod.render_shapes(r, (96, 80))
    Hm = mod.random_homography(r, (96, 80))
    return mod.warp_image(img, Hm), mod.warp_points(Hm, cs)


def _labels(mod, r):
    _, cs = mod.render_shapes(r, (96, 80))
    cells = mod.cells_from_corners(cs, (96, 80))
    return cells, mod.labels65(cells)


def _sampled(mod, r):
    def sampler(rr):
        return mod.render_texture(rr, HW), rr.uniform(4, 60, (5, 2)).astype(np.float32)

    return mod.make_pair_batch_compact(r, 3, HW, sampler=sampler)


GENERATORS = {
    "render_shapes": lambda mod, r: mod.render_shapes(r, (96, 80)),
    "render_texture": lambda mod, r: mod.render_texture(r, (64, 72)),
    "render_view_pair": lambda mod, r: mod.render_view_pair(r, HW),
    "project_view_points": _project,
    "random_homography": lambda mod, r: mod.random_homography(r, (128, 96)),
    "warp_image_and_points": _warps,
    "cell_correspondence": lambda mod, r: mod.cell_correspondence(
        mod.random_homography(r, HW), HW),
    "cells_and_labels65": _labels,
    "make_detector_batch": lambda mod, r: mod.make_detector_batch(r, 3, HW),
    "make_pair_batch_compact": lambda mod, r: mod.make_pair_batch_compact(r, 3, HW),
    "make_pair_batch_compact_sampler": _sampled,
    "make_pair_batch": lambda mod, r: mod.make_pair_batch(r, 3, HW),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_synthetic_identical_to_jax(name):
    """Each generator and batch maker of the copy gives the JAX module's
    arrays bit for bit for two seeds, and leaves the generator in the same
    state."""
    for seed in (0, 11):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        assert_same(GENERATORS[name](tsyn, rt), GENERATORS[name](jsyn, rj))
        assert rj.random() == rt.random()


def test_synthetic_properties():
    """tests/test_pretrain.py:28-86 on the port's copy: labels decode to
    corners, one-hot labels, homography round trip, a warped dot lands
    where its point goes, the identity correspondence, batch shapes."""
    for seed in range(5):
        img, corners = tsyn.render_shapes(np.random.default_rng(seed), (96, 96))
        assert img.shape == (96, 96) and img.dtype == np.float32
        assert 0.0 <= img.min() and img.max() <= 1.0
        cells = tsyn.cells_from_corners(corners, (96, 96))
        for cy, cx in zip(*np.nonzero(cells != tsyn.DUSTBIN)):
            v = cells[cy, cx]
            px, py = cx * tsyn.CELL + (v % tsyn.CELL), cy * tsyn.CELL + (v // tsyn.CELL)
            assert np.hypot(corners[:, 0] - px, corners[:, 1] - py).min() < 1.0
    lab = tsyn.labels65(np.array([[0, tsyn.DUSTBIN], [63, 7]], np.int32))
    assert lab.shape == (2, 2, 65) and lab.sum() == 4.0 and lab[0, 1, tsyn.DUSTBIN] == 1.0
    r = np.random.default_rng(3)
    H = tsyn.random_homography(r, (128, 128))
    pts = r.uniform(20, 100, (50, 2))
    np.testing.assert_allclose(tsyn.warp_points(np.linalg.inv(H), tsyn.warp_points(H, pts)),
                               pts, atol=1e-6)
    dot = np.zeros((96, 96), np.float32)
    dot[40, 30] = 1.0
    H = tsyn.random_homography(np.random.default_rng(5), (96, 96))
    w = tsyn.warp_image(dot, H)
    tx, ty = tsyn.warp_points(H, np.array([[30.0, 40.0]]))[0]
    if 2 <= tx < 94 and 2 <= ty < 94:
        yy, xx = np.unravel_index(np.argmax(w), w.shape)
        assert np.hypot(xx - tx, yy - ty) <= 1.5
    idx, valid = tsyn.cell_correspondence(np.eye(3), (64, 64))
    assert valid.all()
    np.testing.assert_array_equal(idx, np.arange(64))
    b = tsyn.make_pair_batch(np.random.default_rng(0), 2, (64, 64))
    assert b["img_a"].shape == (2, 64, 64, 1) and b["lab_b"].shape == (2, 8, 8, 65)
    assert b["corr_idx"].shape == (2, 64) and b["corr_valid"].dtype == bool


# -- the losses ------------------------------------------------------------------------


def _grads_match(got, ref, rel=1e-5):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=rel * max(np.abs(r).max(), 1e-12))


def test_detector_and_descriptor_losses_match_jax():
    """Values within 1e-6 relative and gradients within 1e-5 of their
    magnitude, for the detector cross-entropy, the identity InfoNCE and the
    correspondence InfoNCE; one descriptor cell exactly zero (the ReLU
    stack's case), whose gradient stays finite through rsqrt(sum + 1e-8)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=2.0, size=(2, 4, 5, 65)).astype(np.float32)
    labels = np.eye(65, dtype=np.float32)[rng.integers(0, 65, (2, 4, 5))]
    da = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    db = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    da[0, 1, 2] = 0.0
    db[1, 0, 0] = 0.0
    idx = rng.integers(0, 20, (2, 20)).astype(np.int32)
    valid = rng.random((2, 20)) > 0.3
    cases = [
        (jtrain._detector_loss, ttrain._detector_loss, (logits, labels), 1),
        (jtrain._descriptor_loss, ttrain._descriptor_loss, (da, db), 2),
        (lambda a, b: jtrain._descriptor_loss_corr(a, b, jnp.asarray(idx), jnp.asarray(valid)),
         lambda a, b: ttrain._descriptor_loss_corr(a, b, T(idx), T(valid)), (da, db), 2),
    ]
    for jf, tf, args, n_grad in cases:
        val, grads = jax.jit(jax.value_and_grad(jf, argnums=tuple(range(n_grad))))(
            *(jnp.asarray(a) for a in args))
        targs = [T(a).requires_grad_(i < n_grad) for i, a in enumerate(args)]
        loss = tf(*targs)
        loss.backward()
        np.testing.assert_allclose(float(loss), float(val), rtol=1e-6)
        _grads_match([t.grad.numpy() for t in targs[:n_grad]], grads)


def test_lightglue_loss_matches_jax_with_a_shared_partner():
    """The three-class loss per pair: values within 1e-6 relative and
    gradients within 1e-5 of their magnitude, with ignored (-2) and
    unmatchable (-1) rows, invalid slots, ignore1, and two ground-truth
    matches to one set-1 keypoint (index 0, where a scatter-set of the
    clipped -1 rows would clobber the real hit)."""
    rng = np.random.default_rng(1)
    B, N0, N1 = 2, 12, 10
    la = rng.normal(size=(B, N0, N1)).astype(np.float32) - 3.0
    m0 = rng.uniform(0.05, 0.95, (B, N0)).astype(np.float32)
    m1 = rng.uniform(0.05, 0.95, (B, N1)).astype(np.float32)
    gt = rng.integers(-2, N1, (B, N0)).astype(np.int32)
    gt[:, :2] = 0                                   # two partners for keypoint 0
    gt[:, 2:4] = -1
    gt[0, 4] = 3
    gt[0, 5] = 3
    v0 = rng.random((B, N0)) > 0.15
    v0[:, :6] = True
    v1 = rng.random((B, N1)) > 0.15
    ign1 = rng.random((B, N1)) > 0.7
    got = ttrain._lightglue_loss(*(T(a).requires_grad_() for a in (la, m0, m1)),
                                 T(gt), T(v0), T(v1), T(ign1))
    for b in range(B):
        def jf(a, p0, p1, b=b):
            return jtrain._lightglue_loss(a, p0, p1, jnp.asarray(gt[b]), jnp.asarray(v0[b]),
                                          jnp.asarray(v1[b]), ignore1=jnp.asarray(ign1[b]))
        ref = jax.jit(jf)(la[b], m0[b], m1[b])
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g[b]), float(r), rtol=1e-6)
    # gradients of the batch mean, as make_lightglue_train_fn takes it
    ins = [T(a).requires_grad_() for a in (la, m0, m1)]
    ttrain._lightglue_loss(*ins, T(gt), T(v0), T(v1), T(ign1))[0].mean().backward()

    def jmean(a, p0, p1):
        return jnp.mean(jax.vmap(lambda *x: jtrain._lightglue_loss(*x)[0])(
            a, p0, p1, jnp.asarray(gt), jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(ign1)))

    grads = jax.jit(jax.grad(jmean, argnums=(0, 1, 2)))(la, m0, m1)
    _grads_match([t.grad.numpy() for t in ins], grads)


# -- optax in torch ---------------------------------------------------------------


@pytest.mark.parametrize("init,peak,warmup,decay,end", [
    (0.0, 1e-3, 1, 8, 5e-5),        # pretrain.train at steps 8
    (0.0, 2e-4, 3, 20, 2e-5),       # train_lightglue's form
    (0.0, 1e-4, 100, 960, 5e-6),    # the bundled fine-tune recipe
])
def test_schedule_matches_optax(init, peak, warmup, decay, end):
    """Every count of a run and past its end, within float32 rounding."""
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    got = ttrain.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    counts = list(range(decay + 5))
    np.testing.assert_allclose([got(c) for c in counts],
                               np.asarray(jax.vmap(ref)(jnp.asarray(counts))),
                               rtol=2e-6, atol=1e-12)
    assert got(0) == init


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the norm the gradients stay as they are, bit for bit; above it
    they become g / ||g|| * max_norm (within 1e-6 relative)."""
    rng = np.random.default_rng(2)
    gs = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
    got = [T(g) for g in gs]
    norm = ttrain.clip_by_global_norm_(got, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                         for g in gs)), rtol=1e-6)
    for g, r in zip(got, ref):
        if scale < 1:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_adam_updates_match_optax():
    """Three updates fed the same gradients: optax.chain(clip_by_global_norm,
    adam(schedule)) against Adam(schedule, clip_norm): the first at lr 0
    leaves the parameters as they were, the others agree within 1e-6 of
    the parameters' magnitude."""
    rng = np.random.default_rng(3)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (6,))]
    grads = [[(rng.normal(size=p.shape) * (0.3 + 3 * k)).astype(np.float32) for p in p0]
             for k in range(3)]
    sched_j = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 5, 1e-3)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched_j))
    params = [jnp.asarray(p) for p in p0]
    st = tx.init(params)
    ours = [torch.nn.Parameter(T(p)) for p in p0]
    ttx = ttrain.Adam(ttrain.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 5, 1e-3), clip_norm=1.0)
    opt = ttx.init(ours)
    for k in range(3):
        upd, st = tx.update([jnp.asarray(g) for g in grads[k]], st, params)
        params = optax.apply_updates(params, upd)
        for p, g in zip(ours, grads[k]):
            p.grad = T(g)
        ttx.update(opt, k)
        for p, r in zip(ours, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), atol=1e-6)
        if k == 0:
            for p, r in zip(ours, p0):
                np.testing.assert_array_equal(p.detach().numpy(), r)


# -- the trainers -------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshConfig(model_parallel=1))


@pytest.fixture(scope="module")
def sp_init():
    """The JAX SuperPoint initialisation (PRNGKey(0)), as a Flax tree and flat."""
    params = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    return params, flat_flax(params)


def _port_superpoint(flat):
    net = SuperPointNet()
    net.load_state_dict(flax_to_state_dict(flat, net))
    return net


def assert_losses(got, ref):
    """Losses step by step: the first step (same parameters) within 1e-5
    relative; later steps within 5e-3 relative, since Adam's first update,
    lr * g / (|g| + 1e-8), moves a parameter by about +-lr for any gradient
    near zero, whose sign the frameworks' rounding decides."""
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=5e-3)


def test_pair_train_step_matches_jax(sp_init, mesh):
    """make_pair_train_step at 64x64, batch 8, Adam 1e-3, from the JAX
    initialisation: the first step's gradients within GRAD_TOL of
    jax.grad's, and the losses of 3 steps as assert_losses holds them."""
    params, flat = sp_init
    params = jax.tree_util.tree_map(jnp.array, params)   # the steps donate their state
    model = JaxSuperPoint()
    tx = optax.adam(1e-3)
    state = jtrain.TrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_pair_train_step(model, tx, mesh)
    net = _port_superpoint(flat)
    ttx = ttrain.Adam(1e-3)
    tstate = ttrain.TrainState(net, ttx.init(net.parameters()), 0)
    tstep = ttrain.make_pair_train_step(net, ttx)
    rng = np.random.default_rng(0)
    batches = [tsyn.make_pair_batch(rng, 8, HW) for _ in range(3)]

    def jloss(p, b):
        la, da = model.apply(p, b["img_a"])
        lb, db = model.apply(p, b["img_b"])
        return (jtrain._detector_loss(la, b["lab_a"]) + jtrain._detector_loss(lb, b["lab_b"])
                + jtrain._descriptor_loss_corr(da, db, b["corr_idx"], b["corr_valid"]))

    jgrads = flat_flax(jax.jit(jax.grad(jloss))(params, {k: jnp.asarray(v) for k, v in
                                                         batches[0].items()}))
    ref, got = [], []
    with mesh:
        for k, b in enumerate(batches):
            state, lj = step(state, {k2: jnp.asarray(v) for k2, v in b.items()})
            tstate, lt = tstep(tstate, {k2: T(v) for k2, v in b.items()})
            ref.append(np.asarray(lj))
            got.append(lt.numpy())
            if k == 0:
                tgrads = {n: p.grad.clone() for n, p in net.named_parameters()}
                errs = grad_errors(_grads_as_flax(net, tgrads), jgrads)
                assert max(errs.values()) < GRAD_TOL, errs
    assert tstate.step == 3 and int(state.step) == 3
    assert_losses(np.array(got), np.array(ref))


def _grads_as_flax(net, grads):
    """Gradients laid out as Flax parameters (state_dict_to_flax's layout)."""
    from recon3d_tpu_torch.neural.weights import state_dict_to_flax

    saved = {n: p.detach().clone() for n, p in net.named_parameters()}
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(grads[n])
        out = state_dict_to_flax(net)
        for n, p in net.named_parameters():
            p.copy_(saved[n])
    return out


def test_epoch_train_fn_matches_jax(sp_init, mesh):
    """make_epoch_train_fn, 2 compact batches of 8 at 64x64 x 2 epochs
    (step i takes batch i % 2) from the JAX initialisation: the (4, 3)
    losses as assert_losses holds them, the decode of the compact batches
    included."""
    params, flat = sp_init
    params = jax.tree_util.tree_map(jnp.array, params)   # the steps donate their state
    model = JaxSuperPoint()
    tx = optax.adam(1e-3)
    state = jtrain.TrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32))
    run = jtrain.make_epoch_train_fn(model, tx, mesh, epochs=2)
    net = _port_superpoint(flat)
    ttx = ttrain.Adam(1e-3)
    trun = ttrain.make_epoch_train_fn(net, ttx, epochs=2)
    rng = np.random.default_rng(1)
    data = [tsyn.make_pair_batch_compact(rng, 8, HW) for _ in range(2)]
    stacked = {k: np.stack([d[k] for d in data]) for k in data[0]}
    with mesh:
        _, ref = run(state, {k: jnp.asarray(v) for k, v in stacked.items()})
    tstate, got = trun(ttrain.TrainState(net, ttx.init(net.parameters()), 0),
                       {k: T(v) for k, v in stacked.items()})
    assert got.shape == (4, 3) and tstate.step == 4
    assert_losses(got.numpy(), np.asarray(ref))


def test_lightglue_train_fn_matches_jax(mesh):
    """make_lightglue_train_fn at 2 layers, dim 64, 32 keypoints, 2 batches
    of 8 pairs x 2 epochs, clip then Adam under a warmup-cosine schedule,
    from the JAX initialisation: the first step's clipped gradients within
    GRAD_TOL and the (4, 3) losses as assert_losses holds them."""
    K, dim = 32, 64
    jnet = JaxLightGlue(dim=dim, num_layers=2)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((K, dim)), jnp.zeros((K, dim)),
                       jnp.zeros((K, 2)), jnp.zeros((K, 2)), jnp.ones(K, bool),
                       jnp.ones(K, bool))
    flat = flat_flax(params)
    data = lightglue_batch(np.random.default_rng(4), 2, 8, K, dim)

    def jloss(p):
        cb = {k: jnp.asarray(v[0]) for k, v in data.items()}

        def one(d0, d1, x0, x1, v0, v1, g, i1):
            la, m0, m1 = jnet.apply(p, d0, d1, x0, x1, v0, v1)
            return jtrain._lightglue_loss(la, m0, m1, g, v0, v1, ignore1=i1)[0]

        return jnp.mean(jax.vmap(one)(cb["desc0"], cb["desc1"], cb["xy0n"], cb["xy1n"],
                                      cb["valid0"], cb["valid1"], cb["gt_idx"], cb["ignore1"]))

    jgrads, _ = optax.clip_by_global_norm(1.0).update(jax.jit(jax.grad(jloss))(params), None)
    jgrads = flat_flax(jgrads)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 8, 1e-4)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    state = jtrain.TrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32))
    with mesh:
        _, ref = jtrain.make_lightglue_train_fn(jnet, tx, mesh, epochs=2)(
            state, {k: jnp.asarray(v) for k, v in data.items()})
    ref = np.asarray(ref)

    net = LightGlueNet(dim=dim, num_layers=2)
    net.load_state_dict(flax_to_state_dict(flat, net))
    ttx = ttrain.Adam(ttrain.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 8, 1e-4), clip_norm=1.0)
    tstate = ttrain.TrainState(net, ttx.init(net.parameters()), 0)
    tdata = {k: T(v) for k, v in data.items()}
    tstate, first = ttrain.make_lightglue_train_fn(net, ttx, epochs=1)(
        tstate, {k: v[:1] for k, v in tdata.items()})
    errs = grad_errors(_grads_as_flax(net, {n: p.grad for n, p in net.named_parameters()}),
                       jgrads)
    assert max(errs.values()) < GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    # the whole run from the start again
    net.load_state_dict(flax_to_state_dict(flat, net))
    tstate = ttrain.TrainState(net, ttx.init(net.parameters()), 0)
    tstate, got = ttrain.make_lightglue_train_fn(net, ttx, epochs=2)(tstate, tdata)
    assert_losses(got.numpy(), ref)
    np.testing.assert_allclose(first.numpy()[0], ref[0], rtol=1e-5)


def test_mesh_raises_naming_item_12():
    for make in (ttrain.make_pair_train_step, ttrain.make_epoch_train_fn,
                 ttrain.make_lightglue_train_fn):
        with pytest.raises(NotImplementedError, match="item 12"):
            make(SuperPointNet(), ttrain.Adam(1e-3), mesh=object())


def test_create_train_state_steps_from_flax_init():
    """create_train_state: a SuperPointNet drawn as Flax draws it (conv
    kernels at std 1/sqrt(in * kh * kw), zero biases), Adam at lr, step 0;
    one make_pair_train_step on it counts the step and moves the
    parameters."""
    model, tx, state = ttrain.create_train_state(torch.Generator().manual_seed(0), HW,
                                                 lr=1e-3, device="cpu")
    assert state.module is model and state.step == 0 and tx.learning_rate == 1e-3
    w = model.conv2b.weight.detach()
    assert abs(float(w.std()) * (64 * 9) ** 0.5 - 1) < 0.05 and not model.conv2b.bias.any()
    before = model.convDb.weight.detach().clone()
    b = tsyn.make_pair_batch(np.random.default_rng(0), 2, HW)
    state, losses = ttrain.make_pair_train_step(model, tx)(state, {k: T(v) for k, v in b.items()})
    assert state.step == 1 and torch.isfinite(losses).all()
    assert not torch.equal(model.convDb.weight, before)
