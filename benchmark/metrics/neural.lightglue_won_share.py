"""neural.lightglue_won_share: 100 x the pairs whose LightGlue verdict
stood / the pairs run through LightGlue, over the window's scenes of the
neural SfM job: the `neural.lightglue_pairs` counter less
`neural.nn_kept_pairs` (the pairs whose mutual-NN verdict had more
F-RANSAC inliers and replaced LightGlue's). The scenes are those of
neural.match_s. None where the program keeps no such record."""


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
    counters = [r["counters"] for r in scenes]
    if not counters or not all("neural.lightglue_pairs" in c and "neural.nn_kept_pairs" in c
                               for c in counters):
        return None
    pairs = sum(c["neural.lightglue_pairs"] for c in counters)
    kept_nn = sum(c["neural.nn_kept_pairs"] for c in counters)
    return 100.0 * (pairs - kept_nn) / pairs if pairs else None
