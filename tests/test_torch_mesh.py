"""The port's mesh (recon3d_tpu_torch/parallel/) against the JAX package's
(recon3d_tpu/parallel/mesh.py on the 8 virtual CPU devices of
tests/conftest.py): the ('data', 'model') shapes and the row split of a
'data' sharding; how many devices a --devices flag takes; then the ranks themselves, spawned on the
CPU over gloo: their layout and groups, and a failing rank making rank 0
raise within the mesh's timeout instead of hanging."""

import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from recon3d_tpu.config import MeshConfig as JaxMeshConfig
from recon3d_tpu.parallel import mesh as jmesh
from recon3d_tpu_torch.config import MeshConfig
from recon3d_tpu_torch.parallel import MeshError, make_mesh, mesh_shape
from recon3d_tpu_torch.parallel import mesh as tmesh
from recon3d_tpu_torch.parallel import workers

torch.set_num_threads(2)

CONFIGS = [(-1, 1), (-1, 2), (2, 2), (3, 1), (-1, 4), (1, 8), (8, 3)]
# jax cannot build a mesh wider than its devices: only mp <= n
CASES = [(n, dp, mp) for n in (1, 2, 4, 8) for dp, mp in CONFIGS if mp <= n]


@pytest.mark.parametrize("n,dp,mp", CASES)
def test_mesh_shape_matches_jax(n, dp, mp):
    j = jmesh.make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp),
                       devices=jax.devices()[:n])
    assert mesh_shape(MeshConfig(data_parallel=dp, model_parallel=mp), n) == (
        j.shape["data"], j.shape["model"])


@pytest.mark.parametrize("n", [5, 8, 3, 1])
def test_shard_rows_are_a_jax_data_sharding(n):
    """The rows each data index takes: those of a jax 'data' sharding of the
    padded batch, padding dropped."""
    mesh = jmesh.make_mesh(JaxMeshConfig(model_parallel=2))    # data 4
    padded, _ = jmesh.pad_to_multiple(np.arange(1, n + 1), 4)     # padding: 0
    arr = jax.device_put(padded, NamedSharding(mesh, P("data")))
    by_data = {}
    for shard in arr.addressable_shards:
        rows = np.asarray(shard.data)
        by_data[int(np.argwhere(mesh.devices == shard.device)[0][0])] = rows[rows > 0] - 1
    for d, (lo, hi) in enumerate(tmesh.shard_rows(n, 4)):
        np.testing.assert_array_equal(np.arange(lo, hi), by_data[d])


@pytest.fixture
def mesh4():
    """A process holds one mesh at a time: each test makes its own."""
    with make_mesh(MeshConfig(model_parallel=2), devices=4, device="cpu", timeout_s=60) as m:
        yield m


def test_ranks_layout_groups_and_k1_counts(mesh4):
    """Rank r at (r // mp, r % mp) as jax places device r; each data group
    sums its members' values; every rank is its own process and reports
    its K1 counts."""
    assert mesh4.shape == {"data": 2, "model": 2} and mesh4.world == 4
    out = mesh4.call(workers.probe, [{"value": 10 ** r} for r in range(4)])
    assert [(o["rank"], o["data"], o["model"]) for o in out] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert [o["sum"] for o in out] == [101.0, 1010.0, 101.0, 1010.0]
    assert len({o["pid"] for o in out}) == 4
    counts = mesh4.k1_counts()
    assert len(counts) == 4 and all(set(c) == {"kernel", "plain", "by_shape", "by_variant"}
                                    for c in counts)
    by_stage = {}
    with mesh4.record_launches(by_stage, "probe"):
        mesh4.call(workers.probe, [{}] * 4)
    assert by_stage["probe"]["kernel"] == 0 and len(by_stage["probe"]["by_rank"]) == 4


def test_data_rows_of_each_rank():
    """Each rank's rows of a 'data'-sharded batch: ranks of one data index
    (model replicas) get the same rows (the layout alone: no ranks are
    started)."""
    layout = tmesh.Mesh(shape={"data": 2, "model": 2}, rank=0, device=torch.device("cpu"),
                        backend="gloo", share_device=False, timeout_s=1.0)
    assert tmesh.data_rows(layout, 5) == [(0, 3), (0, 3), (3, 5), (3, 5)]
    assert tmesh.data_rows(layout, 1) == [(0, 1), (0, 1), (1, 1), (1, 1)]


@pytest.mark.parametrize("devices,device,n", [(1, "cpu", 1), (0, "cpu", 1), (3, "cpu", 3),
                                              (1, "cuda", 1), (0, "cuda", None),
                                              (64, "cuda", None)])
def test_devices_flag_takes(devices, device, n):
    """--devices N: N CPU ranks; on cuda at most the visible GPUs, and all
    of them for 0, as the JAX CLI takes jax.devices()[:N]."""
    gpus = torch.cuda.device_count()
    want = n if n is not None else gpus
    assert tmesh.mesh_devices(devices, device) == (min(want, gpus) if device == "cuda" else want)


def test_only_functions_of_the_port_are_served():
    with pytest.raises(ValueError, match="recon3d_tpu_torch"):
        workers.function_name(np.sum)
    with pytest.raises(ValueError):
        workers.resolve(("os", "getcwd"))
    assert workers.resolve(workers.function_name(workers.probe)) is workers.probe


def test_a_failing_rank_makes_rank_0_raise_within_the_timeout():
    timeout = 30.0
    mesh = make_mesh(devices=2, device="cpu", timeout_s=timeout)
    try:
        assert [o["sum"] for o in mesh.call(workers.probe, [{"value": 1}, {"value": 2}])] == [3, 3]
        t0 = time.time()
        with pytest.raises(MeshError, match="rank 1 failed"):
            mesh.call(workers.probe, [{"value": 1}, {"fail": True}])
        assert time.time() - t0 < timeout
        with pytest.raises(MeshError, match="closed"):
            mesh.call(workers.probe, [{}, {}])
        assert all(p.poll() is not None for p in mesh._procs) or not mesh._procs
    finally:
        mesh.close(force=True)
