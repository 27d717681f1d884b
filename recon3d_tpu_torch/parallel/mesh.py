"""The device mesh over torch.distributed ranks.

Port of recon3d_tpu/parallel/mesh.py. The JAX package has one controller:
a process drives every device of a ('data', 'model') mesh and XLA inserts
the collectives. The port keeps one controller. Rank 0 is the calling
process and runs the whole program, host decisions and outputs included.
Ranks 1..N-1 are worker processes (parallel/workers.py) that serve it:
each sharded call on rank 0 sends every rank its slice of the work
(`Mesh.call`); each rank runs it on its device, the device collectives run
over the mesh's groups, and rank 0 gathers the host results. No other rank
takes a host decision, so no two ranks can take different branches around
a collective.

Mesh layout: ('data', 'model'). Rank r sits at data index r // mp and
model index r % mp, as jax's devices.reshape(dp, mp) places device r.
  data  - views, pairs, observations, batch rows;
  model - the output channels of SuperPoint's wide heads
          (neural/train.py::make_sharded_train_step).

Backends: NCCL for the device groups when every rank has a GPU of its
own; gloo for CPU ranks and for ranks that share one GPU
(make_mesh(share_device=True)), where a CUDA tensor goes through the host
for a collective. Host messages always travel over gloo.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from recon3d_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
# How long a rank waits on another inside a sharded call before it raises.
DEFAULT_TIMEOUT_S = 1800.0
# Workers wait for their next call on a group of their own with this
# timeout: the controller may run host code for hours between calls.
_IDLE_TIMEOUT = datetime.timedelta(days=7)
_PKG_ROOT = Path(__file__).resolve().parents[2]


def mesh_shape(config: Optional[MeshConfig], n_devices: int) -> Tuple[int, int]:
    """(dp, mp) of a mesh over n_devices, by recon3d_tpu/parallel/mesh.py:
    29-43: mp = model_parallel, dp = data_parallel or n // mp, capped at
    n // mp. dp * mp devices are used."""
    config = config or MeshConfig()
    mp = max(1, config.model_parallel)
    dp = config.data_parallel if config.data_parallel > 0 else n_devices // mp
    dp = max(1, min(dp, n_devices // mp))
    return dp, mp


def shard_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """Row ranges [lo, hi) of `parts` shards of n rows: the rows padded to a
    multiple of `parts` and split evenly (a jax 'data' sharding), the
    padding dropped. Trailing shards may be short or empty."""
    per = -(-n // parts) if n else 0
    return [(min(n, d * per), min(n, (d + 1) * per)) for d in range(parts)]


def chunk_rows_in_order(parts: List[Sequence[np.ndarray]], n: int, chunk: int) -> List[np.ndarray]:
    """Reassemble fields computed chunk by chunk with each chunk's rows
    sharded (shard_rows): parts[d] holds data index d's rows of every chunk,
    concatenated; returns each field's n rows in their original order."""
    n_data = len(parts)
    offsets = [0] * n_data
    pieces = []
    for c0 in range(0, n, chunk):
        for d, (lo, hi) in enumerate(shard_rows(min(chunk, n - c0), n_data)):
            if hi > lo:
                pieces.append((d, offsets[d], hi - lo))
                offsets[d] += hi - lo
    n_fields = len(next(p for p in parts if p is not None and len(p)))
    return [np.concatenate([parts[d][f][o: o + k] for d, o, k in pieces], axis=0)
            for f in range(n_fields)]


def to_host(x):
    """Tensors (nested in lists, tuples and dicts) moved to the CPU: what
    crosses between ranks is host data."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, tuple):   # a NamedTuple
        return type(x)(*(to_host(v) for v in x))
    return x


class MeshError(RuntimeError):
    """A rank of the mesh failed or stopped answering; the mesh is closed."""


@dataclass
class Mesh:
    """One rank's view of the mesh. On rank 0 (the controller) `call` runs
    a sharded function on every rank; workers hold the same object for
    the functions they serve.

    shape: {'data': dp, 'model': mp}. device: this rank's torch device.
    backend: of the device groups, 'nccl' or 'gloo'. cache: per-rank state
    that outlives a call (model replicas, matchers)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    share_device: bool
    timeout_s: float
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None
    idle_group: Any = None
    store: Any = None
    cache: Dict[str, Any] = field(default_factory=dict)
    _procs: List[subprocess.Popen] = field(default_factory=list)
    _tmpdir: Optional[str] = None
    _closed: bool = False

    # -- layout ---------------------------------------------------------------

    @property
    def world(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[MODEL_AXIS]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[MODEL_AXIS]

    def data_index_of(self, rank: int) -> int:
        return rank // self.shape[MODEL_AXIS]

    def model_index_of(self, rank: int) -> int:
        return rank % self.shape[MODEL_AXIS]

    # -- collectives on this rank's groups --------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """Sum t in place over this rank's group along `axis` (every rank
        of the group gets the same sum). Returns t."""
        group = self.data_group if axis == DATA_AXIS else self.model_group
        if self._staged(t) or not t.is_contiguous():
            buf = t.cpu() if self._staged(t) else t.contiguous()
            dist.all_reduce(buf, group=group)
            t.copy_(buf)
        else:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int, axis: str = MODEL_AXIS) -> torch.Tensor:
        """The group's tensors along `axis` concatenated along dim, in the
        order of their index on that axis (not differentiable: see
        neural/train.py for the autograd forms)."""
        group = self.model_group if axis == MODEL_AXIS else self.data_group
        n = self.shape[axis]
        src = t.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    # -- the controller's side ----------------------------------------------------

    def call(self, fn: Callable, payloads: Sequence[Any]) -> List[Any]:
        """Run fn(mesh, payloads[r]) on every rank r, rank 0 in this process,
        and return the ranks' results in rank order. fn must be a
        module-level function of recon3d_tpu_torch; payloads and results
        are host data (numpy, CPU tensors, Python values).

        If a rank raises or stops answering within the timeout, the mesh is
        closed and MeshError names the rank and its traceback."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 calls a sharded function")
        if self._closed:
            raise MeshError("the mesh is closed")
        if len(payloads) != self.world:
            raise ValueError(f"{len(payloads)} payloads for a world of {self.world}")
        from recon3d_tpu_torch.parallel import workers

        target = workers.function_name(fn)
        try:
            for r in range(1, self.world):
                workers.send_bytes(pickle.dumps((target, to_host(payloads[r]))), r,
                                   self.idle_group)
            own = fn(self, payloads[0])
            results = [own]
            for r in range(1, self.world):
                results.append(pickle.loads(workers.recv_bytes(r, self.host_group)))
            return results
        except BaseException as e:
            failed = self._worker_errors()
            self.close(force=True)
            if failed:
                raise MeshError("; ".join(f"rank {r} failed:\n{tb}" for r, tb in failed)) from e
            if isinstance(e, Exception):
                raise MeshError(f"sharded call {target} failed on rank 0 or lost a rank: "
                                f"{type(e).__name__}: {e}") from e
            raise

    def _worker_errors(self) -> List[Tuple[int, str]]:
        """The tracebacks the workers left in the store before they exited."""
        out = []
        if self.store is None:
            return out
        deadline = time.time() + 5.0
        for r in range(1, self.world):
            key = f"error/{r}"
            while True:
                try:
                    if self.store.check([key]):
                        out.append((r, self.store.get(key).decode(errors="replace")))
                        break
                except Exception:
                    break
                proc = self._procs[r - 1] if r - 1 < len(self._procs) else None
                if proc is None or proc.poll() is None or time.time() > deadline:
                    break   # alive (blocked on another rank), or no word in time
                time.sleep(0.05)
        return out

    def k1_counts(self) -> List[dict]:
        """K1's launch counts (kernels/warp.py `counts`) on every rank."""
        from recon3d_tpu_torch.parallel import workers

        return self.call(workers.k1_counts, [None] * self.world)

    @contextlib.contextmanager
    def record_launches(self, by_stage: dict, name: str):
        """kernels.warp.record_launches over every rank: by_stage[name]
        holds the launches summed over the ranks, and the same record of
        each rank under 'by_rank'."""
        before = self.k1_counts()
        yield
        after = self.k1_counts()
        per = []
        for b, a in zip(before, after):
            per.append({"kernel": a["kernel"] - b["kernel"], "plain": a["plain"] - b["plain"],
                        "kernel_by_shape": dict(Counter(a["by_shape"]) - Counter(b["by_shape"])),
                        "kernel_by_variant": dict(Counter(a["by_variant"])
                                                  - Counter(b["by_variant"]))})
        total = {"kernel": sum(p["kernel"] for p in per),
                 "plain": sum(p["plain"] for p in per)}
        for key in ("kernel_by_shape", "kernel_by_variant"):
            c = Counter()
            for p in per:
                c.update(p[key])
            total[key] = dict(c)
        total["by_rank"] = per
        by_stage[name] = total

    def close(self, force: bool = False) -> None:
        """Stop the workers (a stop message, then a kill after 10 s, or at
        once with force) and leave the process group."""
        if self._closed:
            return
        self._closed = True
        if self.rank == 0:
            from recon3d_tpu_torch.parallel import workers

            if not force:
                for r in range(1, self.world):
                    try:
                        workers.send_bytes(pickle.dumps(None), r, self.idle_group)
                    except Exception:
                        force = True
            deadline = time.time() + (0.0 if force else 10.0)
            for p in self._procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    pass
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self._procs.clear()
        with contextlib.suppress(Exception):
            dist.destroy_process_group()
        self.store = None
        if self._tmpdir:
            shutil.rmtree(self._tmpdir, ignore_errors=True)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)


def _rank_device(device: torch.device, rank: int, share_device: bool) -> torch.device:
    if device.type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", 0 if share_device else rank)


def init_rank(rank: int, shape: Dict[str, int], device: torch.device, backend: str,
              share_device: bool, store, timeout_s: float) -> Mesh:
    """Join the process group and build this rank's groups: every rank
    creates every group, in the same order."""
    dp, mp = shape[DATA_AXIS], shape[MODEL_AXIS]
    world = dp * mp
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("gloo", store=dist.PrefixStore("pg", store), rank=rank,
                            world_size=world, timeout=timeout)
    idle = dist.new_group(list(range(world)), timeout=_IDLE_TIMEOUT, backend="gloo")
    mesh = Mesh(shape=dict(shape), rank=rank, device=device, backend=backend,
                share_device=share_device, timeout_s=timeout_s,
                host_group=dist.group.WORLD, idle_group=idle, store=store)
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)], timeout=timeout, backend=backend)
        if mesh.model_index == m:
            mesh.data_group = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)], timeout=timeout, backend=backend)
        if mesh.data_index == d:
            mesh.model_group = g
    return mesh


def _loopback_env() -> Dict[str, str]:
    """Every rank runs on this host: gloo and NCCL talk over loopback."""
    return {"GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
            "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo")}


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Union[None, int, Sequence] = None,
    device="cuda",
    share_device: bool = False,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Mesh:
    """Build a ('data', 'model') mesh: this process becomes rank 0 and
    dp * mp - 1 worker processes are started (python -m
    recon3d_tpu_torch.parallel.workers, each a fresh interpreter that
    imports the port alone).

    devices: how many devices (or a sequence of them, counted); default
    every visible GPU on "cuda", one rank on "cpu". On "cuda" rank r takes
    GPU r, over NCCL; with share_device=True every rank shares the first
    GPU over gloo (NCCL refuses two ranks on one GPU). On "cpu" a count
    asks for that many CPU ranks over gloo. Close the mesh (close(), or
    use it as a context manager) to stop the workers; one mesh at a time
    per process."""
    from recon3d_tpu_torch.runtime.device import resolve_device

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("this process already holds a mesh (a process group): close it first")
    if devices is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    elif isinstance(devices, int):
        n = devices
    else:
        n = len(devices)
    if dev.type == "cuda" and not share_device and n > torch.cuda.device_count():
        raise ValueError(f"{n} devices asked for, {torch.cuda.device_count()} GPUs visible")
    dp, mp = mesh_shape(config, n)
    if dp * mp < 1:
        raise ValueError(f"no mesh of {config} fits {n} devices")
    shape = {DATA_AXIS: dp, MODEL_AXIS: mp}
    world = dp * mp
    backend = "nccl" if dev.type == "cuda" and not share_device else "gloo"
    if dev.type == "cuda":
        # build K1, the bundle kernels and LightGlue's attention once, before
        # the ranks start: they load the same libraries
        from recon3d_tpu_torch.kernels import attention, bundle, warp

        warp.build()
        bundle.build()
        attention.build()
        torch.cuda.set_device(_rank_device(dev, 0, share_device))
    for k, v in _loopback_env().items():
        os.environ.setdefault(k, v)
    tmpdir = tempfile.mkdtemp(prefix="recon3d_mesh_")
    store = dist.FileStore(os.path.join(tmpdir, "store"), world)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_PKG_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    try:
        for r in range(1, world):
            cmd = [sys.executable, "-m", "recon3d_tpu_torch.parallel.workers",
                   "--rank", str(r), "--dp", str(dp), "--mp", str(mp),
                   "--device", str(_rank_device(dev, r, share_device)),
                   "--backend", backend, "--store", os.path.join(tmpdir, "store"),
                   "--timeout", str(timeout_s)] + (["--share-device"] if share_device else [])
            procs.append(subprocess.Popen(cmd, env=env))
        mesh = init_rank(0, shape, _rank_device(dev, 0, share_device), backend,
                         share_device, store, timeout_s)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    mesh._procs = procs
    mesh._tmpdir = tmpdir
    return mesh


def mesh_devices(devices: int, device) -> int:
    """How many devices a --devices flag asks for on `device`: every
    visible GPU for 0, else at most that many (as the JAX CLI takes
    jax.devices()[:n]); on the CPU, N ranks (0 or 1: one)."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        return n if devices <= 0 else min(devices, n)
    return max(devices, 1)


def auto_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """A data-parallel mesh over every visible GPU when there are at least
    `min_devices`, else None (as the JAX package's on fewer devices)."""
    n = torch.cuda.device_count()
    if n < min_devices:
        return None
    return make_mesh(MeshConfig(model_parallel=1), devices=n, device="cuda")


def data_parallel_mesh(n: int, device) -> Optional[Mesh]:
    """The entry points' mesh: data-parallel over n devices, or None for
    one (no mesh is built and the single-device path runs)."""
    if n <= 1:
        return None
    mesh = make_mesh(MeshConfig(model_parallel=1), devices=n, device=device)
    print(f"[mesh] data-parallel over {mesh.shape[DATA_AXIS]} devices")
    return mesh


def data_rows(mesh: Mesh, n: int) -> List[Tuple[int, int]]:
    """Each rank's rows of an n-row batch sharded over 'data' (ranks of one
    data index get the same rows)."""
    parts = shard_rows(n, mesh.shape[DATA_AXIS])
    return [parts[mesh.data_index_of(r)] for r in range(mesh.world)]


@dataclass(frozen=True)
class Sharding:
    """Where an array lives on a mesh, the port's counterpart of a jax
    NamedSharding: `axis` of an ndim-dimensional array split over 'data'
    (shard_rows), or held whole by every rank when axis is None."""

    mesh: Mesh
    ndim: int
    axis: Optional[int]


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> Sharding:
    """Shard array axis `axis` over the data mesh axis, replicate the rest."""
    return Sharding(mesh, ndim, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, 0, None)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad a host array so axis size is divisible by `multiple`.

    Returns (padded, original_size). Sharded batch axes must divide the mesh.
    """
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad), n


def shard_batch(x, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """This rank's rows of x along `axis` under data_sharding(mesh, x.ndim,
    axis), as a tensor on the rank's device: the JAX function's device_put
    seen from one rank (every rank of a data index holds the same rows)."""
    t = torch.as_tensor(x)
    lo, hi = data_rows(mesh, t.shape[axis])[mesh.rank]
    return t.narrow(axis, lo, hi - lo).to(mesh.device)
