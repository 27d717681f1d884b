"""sfm.pull_wait_s: seconds a scene the host spent blocked in `host.pull`
spans, waiting on the device, mean over the window's SfM scenes.

The scenes are the port's finished root spans (recon3d_tpu_torch/runtime/
profiling.py `finished()`): the last len(rec["stats"]) of those named
`sfm.reconstruct` that ended without an error, before the newest, which is
the profiled scene. None where the program keeps no such record."""


def _window(rec):
    try:
        from recon3d_tpu_torch.runtime.profiling import finished
    except ImportError:
        return []
    n = len(rec["stats"])
    roots = [r for r in finished() if r["name"] == "sfm.reconstruct" and r["ok"]]
    return roots[-n - 1:-1] if rec["job"] == "sfm" and n and len(roots) > n else []


def read(rec):
    scenes = _window(rec)
    if not scenes:
        return None
    return sum(r["seconds"].get("host.pull", 0.0) for r in scenes) / len(scenes)
