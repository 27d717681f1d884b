"""The plain references at a tiny size on the CPU: the similarity
alignment, the distance to the scene, and the dense reference against the
port's own maps and cloud (the confidence recomputed in float64, the
fusion and the cloud's back-projection)."""

import numpy as np
import torch
import pytest

from benchmark import scene
from benchmark.reference import mvs, sfm


def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(20, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = q * np.sign(np.linalg.det(q))
    s, Rr, t = sfm.umeyama(src, 2.5 * src @ R.T + np.array([1.0, -2.0, 0.5]))
    assert s == pytest.approx(2.5) and np.allclose(Rr, R) and np.allclose(t, [1, -2, 0.5])


def test_sfm_check_of_the_truth_is_exact():
    spec = scene.scene_spec({"views": 5, "height": 48, "width": 64, "arc_span_rad": 1.0,
                             "focal_factor": 0.9,
                             "texture": scene.RENDER_VIEWS_TEXTURE}, seed=3, k=0)
    cap = scene.render(spec, "cpu")
    truth = sfm.control_scene(cap, 100, seed=3, dtype=torch.float64)
    # the truth in another frame: scaled by 0.3, turned; the keypoints stay
    a = 0.4
    Q = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    poses = {i: (cap["Rs"][i] @ Q.T, 0.3 * cap["ts"][i]) for i in range(5)}
    nums = sfm.check_scene(cap, dict(truth, poses=poses,
                                     points=0.3 * truth["points"].astype(np.float64) @ Q.T))
    assert nums["registered_share"] == 1.0
    assert nums["rot_err_max_deg"] < 1e-4
    assert nums["point_dist_med"] < 1e-5
    assert nums["reproj_med_px"] < 1e-3
    assert sum(len(o) for o in truth["observations"]) >= 100


def test_dense_reference_agrees_with_the_port():
    from benchmark.tests._tiny import files
    from benchmark import run

    f = files("dtu49.mvs")
    f["config"].update(views=6, height=192, width=256)
    job = run.load_module(run.BENCH / "jobs" / "mvs.py", "job_mvs_ref")
    state = job.setup(f["config"], dict(f["traffic"], pool=1), 11, "cpu")
    out = job.run(state, 0)
    nums = job.check(state, out)
    assert nums["cloud_err_max"] < 1e-6          # float32 back-projection
    assert nums["cloud_count_dev"] < 1e-3
    assert nums["conf_mismatch"] < 0.01          # the port's float32 box sums
    # the same numbers of the reference's own confidence are exact
    s = state["pool"][0]
    K = mvs.working_K(s["inputs"]["K"], 0.25)
    sparse = s["inputs"]["sparse"]
    Rs, ts = s["inputs"]["Rs"], s["inputs"]["ts"]
    src = mvs.source_views(Rs, ts, np.median(sparse, axis=0), 4, 5.0, 60.0)
    gray = mvs.small_gray(s["inputs"]["images"], out["depth"].shape[1:], "cpu")
    conf, _ = mvs.confidence(out["depth"], gray, K, Rs, ts, src,
                          mvs.near_depths(sparse, Rs, ts) * 0.05, 11, 0.6)
    again = dict(out, conf=conf)
    assert job.check(state, again)["conf_mismatch"] == 0.0


def test_dense_control_in_float64_is_exact():
    """The dense reference's own answer, kept in float64, reads no error:
    the true depth along the working camera's rays, its confidence and its
    fusion agree with the checks that judge them."""
    from benchmark.tests._tiny import files
    from benchmark import run

    f = files("dtu49.mvs")
    f["config"].update(views=6, height=192, width=256)
    job = run.load_module(run.BENCH / "jobs" / "mvs.py", "job_mvs_ctl")
    state = job.setup(f["config"], dict(f["traffic"], pool=1), 12, "cpu")
    nums = job.check(state, job.control(state, 0, torch.float64))
    assert nums["depth_err_med"] < 1e-6           # the float32 copy of the depth
    assert nums["cloud_err_max"] < 1e-6
    assert nums["cloud_count_dev"] == 0.0
    assert nums["fused_share_min"] > 0.5
