"""neural.match_s: seconds a scene in the `neural.match` span: all of
NeuralMatcher.match_pairs_batched (LightGlue, the mutual-NN fallback and
F-RANSAC of every candidate pair, up to the host read of the results),
mean over the window's scenes of the neural SfM job.

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
    return roots[-n - 1:-1] if rec["job"] == "sfm_neural" and n and len(roots) > n else []


def read(rec):
    scenes = _window(rec)
    if not scenes or not all("neural.match" in r["seconds"] for r in scenes):
        return None
    return sum(r["seconds"]["neural.match"] for r in scenes) / len(scenes)
