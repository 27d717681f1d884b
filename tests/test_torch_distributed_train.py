"""The port's sharded training on the CPU, four gloo ranks spawned by
parallel.make_mesh as a ('data', 'model') = (2, 2) mesh, against the port
on one device and the JAX trainers on the 8 virtual devices of
tests/conftest.py (mirrors the trainers' mesh use in tests/test_pretrain.py
and recon3d_tpu/neural/train.py:307-354): the data-parallel pair step,
epoch and LightGlue trainers (their batch split over 'data', the model
ranks replicas), and make_sharded_train_step with SuperPoint's wide heads
split over 'model'. Losses as tests/test_torch_train.py holds them: the
first step within 1e-5 relative, later ones within 5e-3. The gradients
after the first step's all_reduce, tensor by tensor, within GRAD_TOL
(tests/torch_train_check.py: 2e-3 relative L2) of one device's, and for
the sharded step of jax.grad's too: a step's loss is computed before its update, and Adam's
update does not change when every gradient is scaled, so only the
gradients show a missing, doubled or partial all_reduce."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.config import MeshConfig as JaxMeshConfig
from recon3d_tpu.neural import train as jtrain
from recon3d_tpu.neural.superpoint import SuperPointNet as JaxSuperPoint
from recon3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recon3d_tpu_torch.config import MeshConfig
from recon3d_tpu_torch.convert import flax_to_state_dict
from recon3d_tpu_torch.neural import synthetic as tsyn
from recon3d_tpu_torch.neural import train as ttrain
from recon3d_tpu_torch.neural.lightglue import LightGlueNet
from recon3d_tpu_torch.neural.superpoint import SuperPointNet
from recon3d_tpu_torch.neural.weights import flax_init_
from recon3d_tpu_torch.parallel import make_mesh
from tests.test_torch_train import T, assert_losses, flat_flax
from tests.torch_train_check import GRAD_TOL, grad_errors, lightglue_batch

torch.set_num_threads(2)

HW = (32, 32)


@pytest.fixture(scope="module")
def mesh():
    with make_mesh(MeshConfig(model_parallel=2), devices=4, device="cpu", timeout_s=300) as m:
        yield m


@pytest.fixture(scope="module")
def sp_init():
    params = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    return params, flat_flax(params)


def _port_superpoint(flat):
    net = SuperPointNet()
    net.load_state_dict(flax_to_state_dict(flat, net))
    return net


def _grads(net) -> dict:
    return {n: q.grad.numpy().copy() for n, q in net.named_parameters()}


def _port_layout(jgrads, names) -> dict:
    """jax.grad's gradients as the port's parameters (names of them)."""
    sd = flax_to_state_dict(flat_flax(jgrads), SuperPointNet())
    return {n: sd[n].numpy() for n in names}


def assert_grads(got: dict, ref: dict):
    errs = grad_errors(got, ref)
    assert max(errs.values()) < GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


def test_pair_train_step_data_parallel_matches_one_device_and_jax(mesh, sp_init):
    """make_pair_train_step(mesh=): 8 pairs a batch, 4 a data index, 3
    steps, against the port on one device and the JAX step on 8 devices:
    the losses, and the first step's gradients (rank 0's, after the
    all_reduce) against one device's."""
    params, flat = sp_init
    rng = np.random.default_rng(0)
    batches = [tsyn.make_pair_batch(rng, 8, HW) for _ in range(3)]
    runs, grads = [], []
    for m in (None, mesh):
        net = _port_superpoint(flat)
        tx = ttrain.Adam(1e-3)
        state = ttrain.TrainState(net, tx.init(net.parameters()), 0)
        step = ttrain.make_pair_train_step(net, tx, mesh=m)
        losses = []
        for b in batches:
            losses.append(step(state, {k: T(v) for k, v in b.items()})[1].numpy())
            if len(losses) == 1:
                grads.append(_grads(net))
        runs.append(np.stack(losses))
        assert state.step == 3
    single, sharded = runs
    np.testing.assert_allclose(sharded[0], single[0], rtol=1e-5)
    np.testing.assert_allclose(sharded, single, rtol=5e-3)
    # jax.grad's gradients of this batch sit 2.02e-3 (conv1b.weight) from
    # one device's here, over GRAD_TOL: the mesh is held to one device's
    # gradients, and to JAX through the losses
    assert_grads(grads[1], grads[0])
    jm = jax_make_mesh(JaxMeshConfig(model_parallel=1))
    jtx = optax.adam(1e-3)
    p = jax.tree_util.tree_map(jnp.array, params)
    jstate = jtrain.TrainState(params=p, opt_state=jtx.init(p), step=jnp.zeros((), jnp.int32))
    jstep = jtrain.make_pair_train_step(JaxSuperPoint(), jtx, jm)
    ref = []
    with jm:
        for b in batches:
            jstate, l = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            ref.append(np.asarray(l))
    assert_losses(sharded, np.stack(ref))


def test_epoch_and_lightglue_trainers_data_parallel(mesh):
    """make_epoch_train_fn and make_lightglue_train_fn (clip, then Adam under
    a schedule) over the mesh against one device: the (D * epochs, 3)
    losses; a second round continues from the replicas without a resync."""
    rng = np.random.default_rng(1)
    data = [tsyn.make_pair_batch_compact(rng, 4, HW) for _ in range(2)]
    stacked = {k: T(np.stack([d[k] for d in data])) for k in data[0]}
    runs = []
    for m in (None, mesh):
        net = flax_init_(SuperPointNet(), torch.Generator().manual_seed(0))
        tx = ttrain.Adam(ttrain.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 8, 1e-4))
        state = ttrain.TrainState(net, tx.init(net.parameters()), 0)
        run = ttrain.make_epoch_train_fn(net, tx, mesh=m, epochs=2)
        a = run(state, stacked)[1].numpy()
        b = run(state, stacked)[1].numpy()
        runs.append(np.concatenate([a, b]))
        assert state.step == 8
    assert_losses(runs[1], runs[0])

    K, dim = 32, 64
    lg_data = {k: T(v) for k, v in lightglue_batch(np.random.default_rng(4), 2, 4, K,
                                                  dim).items()}
    runs = []
    for m in (None, mesh):
        net = flax_init_(LightGlueNet(dim=dim, num_layers=2), torch.Generator().manual_seed(1))
        tx = ttrain.Adam(ttrain.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 8, 1e-4),
                         clip_norm=1.0)
        state = ttrain.TrainState(net, tx.init(net.parameters()), 0)
        runs.append(ttrain.make_lightglue_train_fn(net, tx, mesh=m, epochs=2)(
            state, lg_data)[1].numpy())
    assert runs[1].shape == (4, 3)
    assert_losses(runs[1], runs[0])


def test_sharded_train_step_matches_one_device_and_jax(mesh, sp_init):
    """make_sharded_train_step at dp=2, mp=2 (the heads' 256 output
    channels 128 a model rank) from the JAX initialisation, 2 steps of 8
    images: the losses against the same step written on one device (loss
    = detector cross-entropy + 0.1 x identity InfoNCE, Adam) and against
    the JAX function at dp=4, mp=2; rank 0's gradients after the first
    step (its head slices: model index 0's channels) against one device's
    and jax.grad's; the gathered parameters after the steps against the
    one-device ones."""
    params, flat = sp_init
    rng = np.random.default_rng(2)
    batches = [tsyn.make_pair_batch(rng, 8, HW) for _ in range(2)]

    ref_net = _port_superpoint(flat)
    rtx = ttrain.Adam(1e-3)
    ropt = rtx.init(ref_net.parameters())
    single = []
    for i, b in enumerate(batches):
        ropt.zero_grad()
        logits, desc = ref_net(T(b["img_a"]))
        loss = (ttrain._detector_loss(logits, T(b["lab_a"]))
                + 0.1 * ttrain._descriptor_loss(desc, desc))
        loss.backward()
        if i == 0:
            ref_grads = _grads(ref_net)
        rtx.update(ropt, i)
        single.append(loss.item())

    net = _port_superpoint(flat)
    step, shard_params = ttrain.make_sharded_train_step(net, ttrain.Adam(1e-3), mesh)
    state = shard_params(net.state_dict())
    assert state.module.convPa.out_channels == 128 and state.module.convPb.in_channels == 256
    got = []
    for b in batches:
        got.append(float(step(state, T(b["img_a"]), T(b["lab_a"]))[1]))
        if len(got) == 1:
            grads = _grads(state.module)

    def rank0_slice(g: dict) -> dict:
        return {n: ttrain._head_slice(n, torch.from_numpy(g[n]), 0, 2).numpy() for n in grads}

    assert_grads(grads, rank0_slice(ref_grads))

    def jloss(p, images, labels65):
        logits, desc = JaxSuperPoint().apply(p, images)
        return jtrain._detector_loss(logits, labels65) + 0.1 * jtrain._descriptor_loss(desc,
                                                                                        desc)

    jg = jax.jit(jax.grad(jloss))(params, jnp.asarray(batches[0]["img_a"]),
                                  jnp.asarray(batches[0]["lab_a"]))
    assert_grads(grads, rank0_slice(_port_layout(jg, ref_grads)))
    np.testing.assert_allclose(got[0], single[0], rtol=1e-5)
    np.testing.assert_allclose(got, single, rtol=5e-3)
    full = step.full_state_dict(state)
    for k, v in ref_net.state_dict().items():
        np.testing.assert_allclose(full[k].numpy(), v.numpy(), atol=2e-3, err_msg=k)

    jm = jax_make_mesh(JaxMeshConfig(model_parallel=2))
    jtx = optax.adam(1e-3)
    jstep, jshard = jtrain.make_sharded_train_step(JaxSuperPoint(), jtx, jm)
    p = jshard(jax.tree_util.tree_map(jnp.array, params))
    jstate = jtrain.TrainState(params=p, opt_state=jtx.init(p), step=jnp.zeros((), jnp.int32))
    ref = []
    with jm:
        for b in batches:
            jstate, l = jstep(jstate, jnp.asarray(b["img_a"]), jnp.asarray(b["lab_a"]))
            ref.append(float(l))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=5e-3)
