"""The worker ranks of a mesh (parallel/mesh.py) and their serve loop.

`make_mesh` starts ranks 1..N-1 as `python -m
recon3d_tpu_torch.parallel.workers --rank R ...`: a fresh interpreter
that imports the port alone (a `multiprocessing` spawn would import the
caller's __main__ in every rank: chip_smoke.py, pytest, an xdist worker).
Each joins the process group and then serves rank 0 until told to stop:

    receive (function, payload)   on the idle group (gloo, long timeout)
    run function(mesh, payload)   on this rank's device, with the
                                  collectives the function makes
    send its result               on the host group (gloo, the mesh's timeout)

The functions a rank runs are named by module and qualified name and must
belong to recon3d_tpu_torch: that is the registry. A rank whose function
raises writes its traceback to the store under error/<rank> and exits, so
that rank 0's next wait on it fails at once instead of at the timeout,
and rank 0 raises MeshError with the traceback. A worker whose rank 0 is
gone exits when its wait fails.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import sys
import traceback
from typing import Callable, Tuple

import torch
import torch.distributed as dist

_PACKAGE = "recon3d_tpu_torch"


def function_name(fn: Callable) -> Tuple[str, str]:
    """(module, qualified name) of a function a worker may run."""
    mod, name = fn.__module__, fn.__qualname__
    if not (mod == _PACKAGE or mod.startswith(_PACKAGE + ".")) or "<" in name:
        raise ValueError(f"{mod}.{name}: a sharded call runs module-level functions of "
                         f"{_PACKAGE} only")
    return mod, name


def resolve(target: Tuple[str, str]) -> Callable:
    mod, name = target
    if not (mod == _PACKAGE or mod.startswith(_PACKAGE + ".")):
        raise ValueError(f"refusing to run {mod}.{name}: not part of {_PACKAGE}")
    obj = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def send_bytes(data: bytes, dst: int, group) -> None:
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
    dist.send(torch.tensor([len(data)], dtype=torch.int64), dst, group=group)
    if len(data):
        dist.send(buf, dst, group=group)


def recv_bytes(src: int, group) -> bytes:
    n = torch.zeros(1, dtype=torch.int64)
    dist.recv(n, src, group=group)
    buf = torch.empty(int(n), dtype=torch.uint8)
    if int(n):
        dist.recv(buf, src, group=group)
    return buf.numpy().tobytes()


def k1_counts(mesh, _payload) -> dict:
    """This rank's K1 launch counts (kernels/warp.py)."""
    from recon3d_tpu_torch.kernels.warp import counts

    return {"kernel": counts.kernel, "plain": counts.plain,
            "by_shape": dict(counts.by_shape), "by_variant": dict(counts.by_variant)}


def probe(mesh, payload: dict) -> dict:
    """The mesh's health check: this rank's layout, the packages it has
    imported, and the sum over the data group of payload['value'] on this
    rank's device. With
    payload['fail'] it raises on this rank instead, which exercises the
    failure path (rank 0 must raise, not hang)."""
    if payload.get("fail"):
        raise RuntimeError(f"probe asked to fail on rank {mesh.rank}")
    t = torch.tensor([float(payload.get("value", 1.0))], device=mesh.device)
    mesh.all_reduce_(t)
    return {"rank": mesh.rank, "data": mesh.data_index, "model": mesh.model_index,
            "device": str(mesh.device), "sum": float(t.item()), "pid": os.getpid(),
            "packages": sorted({m.split(".")[0] for m in sys.modules})}


def time_all_reduce(mesh, payload: dict) -> float:
    """Milliseconds of one all_reduce over the data group of n float32
    values on this rank's device (a CUDA tensor through the host on a
    gloo mesh), the mean of payload['iters'] after one warm-up."""
    import time

    t = torch.ones(int(payload["n"]), dtype=torch.float32, device=mesh.device)
    mesh.all_reduce_(t)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    for _ in range(int(payload["iters"])):
        mesh.all_reduce_(t)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t0) * 1e3 / int(payload["iters"])


def serve(mesh) -> None:
    """Run rank 0's calls until it sends None."""
    while True:
        msg = pickle.loads(recv_bytes(0, mesh.idle_group))
        if msg is None:
            return
        target, payload = msg
        try:
            out = resolve(target)(mesh, payload)
        except Exception:
            tb = traceback.format_exc()
            print(f"[mesh] rank {mesh.rank}: {target[0]}.{target[1]} failed\n{tb}",
                  file=sys.stderr, flush=True)
            try:
                mesh.store.set(f"error/{mesh.rank}", tb)
            finally:
                os._exit(1)
        from recon3d_tpu_torch.parallel.mesh import to_host

        send_bytes(pickle.dumps(to_host(out)), 0, mesh.host_group)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="a worker rank of a recon3d_tpu_torch mesh")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--dp", type=int, required=True)
    p.add_argument("--mp", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--timeout", type=float, required=True)
    p.add_argument("--share-device", action="store_true")
    a = p.parse_args(argv)
    from recon3d_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, init_rank
    from recon3d_tpu_torch.runtime.device import disable_tf32

    device = torch.device(a.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # N ranks on the cores of one host: one thread each
        torch.set_num_threads(1)
    disable_tf32()
    world = a.dp * a.mp
    store = dist.FileStore(a.store, world)
    mesh = init_rank(a.rank, {DATA_AXIS: a.dp, MODEL_AXIS: a.mp}, device, a.backend,
                     a.share_device, store, a.timeout)
    try:
        serve(mesh)
    finally:
        try:
            dist.destroy_process_group()
        except Exception:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
