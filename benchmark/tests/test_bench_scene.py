"""The benchmark's renderer against the repository's numpy renderer
(tests/render.py) at a small size on the CPU."""

import numpy as np
import torch

from benchmark import scene


def test_render_matches_numpy_renderer():
    from tests.render import Plane, render_views

    V, H, W, step, seed = 5, 48, 64, 0.3, 123
    planes = scene.box_corner((11, 22, 33))
    ref = render_views(n_views=V, image_size=(H, W), rng_seed=seed, arc_step=step,
                       arc_offset=0.6,
                       planes=[Plane(np.array(p.origin), np.array(p.u), np.array(p.v),
                                     p.half_u, p.half_v, p.seed) for p in planes])
    # render_views casts with its float32 K and poses; hand the same to cast
    shade, depth = scene.cast(planes, ref["K"], ref["Rs"], ref["ts"], H, W, "cpu",
                              pixel_offset=0.5, texture=scene.RENDER_VIEWS_TEXTURE)
    images = (shade.to(torch.float32)[..., None] * torch.tensor(scene.TINT)).numpy()
    assert np.abs(images - ref["images"]).max() < 1e-6
    assert np.allclose(depth.numpy(), ref["depth"], rtol=2e-7, atol=0)   # render_views keeps float32
    assert (ref["depth"] > 0).mean() > 0.9


def test_arc_and_convention_match_numpy_renderer():
    from tests.render import render_views

    spec = scene.scene_spec({"views": 4, "height": 32, "width": 40, "arc_span_rad": 1.715,
                             "focal_factor": 0.9,
                             "texture": scene.RENDER_VIEWS_TEXTURE}, seed=2**31 + 5, k=1)
    cap = scene.render(spec, "cpu")
    assert cap["images"].shape == (4, 32, 40, 3) and cap["images"].dtype == np.float32
    ref = render_views(n_views=4, image_size=(32, 40), rng_seed=spec["rng_seed"],
                       arc_step=spec["arc_step"], arc_offset=spec["arc_offset"],
                       planes=None)
    # the same cameras (render_views rounds them to float32) ...
    assert np.abs(cap["Rs"] - ref["Rs"]).max() < 1e-6
    assert np.abs(cap["ts"] - ref["ts"]).max() < 1e-6
    # ... and OpenCV's centre is render_views' centre less half a pixel
    assert np.allclose(cap["K"][:2, 2], np.asarray(ref["K"])[:2, 2] - 0.5)


def test_scene_spec_sizes_do_not_depend_on_the_seed():
    cfg = {"views": 49, "height": 1200, "width": 1600, "arc_span_rad": 1.715,
           "focal_factor": 0.9, "texture": scene.RENDER_VIEWS_TEXTURE}
    a = [scene.scene_spec(cfg, 2**33 + 7, k) for k in range(2)]
    b = [scene.scene_spec(cfg, 2**33 + 8, k) for k in range(2)]
    keep = ("views", "height", "width", "arc_step", "arc_offset", "focal_factor")
    assert all({k: x[k] for k in keep} == {k: a[0][k] for k in keep} for x in a + b)
    # the same surface, from other cameras
    assert all(x["plane_seeds"] == [11, 22, 33] for x in a + b)
    assert len({x["rng_seed"] for x in a + b}) == 4
    assert scene.scene_spec(cfg, 2**33 + 7, 0) == a[0]


def test_surface_samples_lie_on_the_planes():
    spec = scene.scene_spec({"views": 3, "height": 64, "width": 80, "arc_span_rad": 1.0,
                             "focal_factor": 0.9,
                             "texture": scene.RENDER_VIEWS_TEXTURE}, seed=9, k=0)
    cap = scene.render(spec, "cpu")
    pts = scene.surface_samples(cap, 50, seed=9, scale=0.5).astype(np.float64)
    from benchmark.reference.sfm import surface_distance

    assert len(pts) == 50
    assert surface_distance(pts, cap["planes"]).max() < 1e-5
