"""I/O, configuration and camera conversion of the PyTorch port against the
JAX package (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from recon3d_tpu.camera import Camera as JaxCamera
from recon3d_tpu.config import PatchMatchConfig as JaxPatchMatchConfig
from recon3d_tpu.config import ReconstructionConfig as JaxConfig
from recon3d_tpu.io import colmap as jcolmap
from recon3d_tpu.io import ply as jply
from recon3d_tpu.io.dataset import load_image_set as jax_load_image_set
from recon3d_tpu_torch.camera import Camera, CameraPose, stack_poses
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.convert import camera_from_numpy, config_from_dict, poses_from_numpy
from recon3d_tpu_torch.io import colmap as tcolmap
from recon3d_tpu_torch.io import ply as tply
from recon3d_tpu_torch.io.dataset import list_images, load_image_set
from tests.render import render_views


def _random_model(rng, n_cams=4, n_pts=30):
    poses = {}
    for c in range(n_cams):
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        if np.linalg.det(R) < 0:
            R = -R
        poses[c] = (R.astype(np.float32), rng.standard_normal(3).astype(np.float32))
    K = np.array([[300.0, 0, 159.5], [0, 310.0, 119.5], [0, 0, 1]], np.float32)
    pts = rng.standard_normal((n_pts, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (n_pts, 3)).astype(np.uint8)
    kp = [rng.random((n_pts, 2)).astype(np.float32) * 300 for _ in range(n_cams)]
    obs = [[(c, p) for c in range(n_cams) if (p + c) % 2 == 0] for p in range(n_pts)]
    return K, poses, pts, cols, obs, kp


@pytest.mark.parametrize("writer,reader", [
    (tcolmap.save_colmap_text, jcolmap.load_colmap_text),
    (jcolmap.save_colmap_text, tcolmap.load_colmap_text),
])
@pytest.mark.parametrize("dist", [None, np.array([-0.1, 0.02, 0.001, 0.0, 0.003], np.float32)])
def test_colmap_round_trip_between_packages(tmp_path, rng, writer, reader, dist):
    K, poses, pts, cols, obs, kp = _random_model(rng)
    names = [f"im_{c}.png" for c in range(4)]
    writer(str(tmp_path), K, (240, 320), poses, pts, cols, observations=obs,
           kp_xy=kp, names=names, dist=dist)
    m = reader(str(tmp_path))
    assert sorted(im.name for im in m.images.values()) == names
    np.testing.assert_allclose(m.points, pts, atol=1e-6)
    np.testing.assert_array_equal(m.colors, cols)
    cam = m.cameras[1]
    np.testing.assert_allclose(cam.K(), K, atol=1e-4)
    np.testing.assert_allclose(cam.dist(), np.zeros(5) if dist is None else dist, atol=1e-7)
    for im in m.images.values():
        c = names.index(im.name)
        np.testing.assert_allclose(im.R(), poses[c][0], atol=1e-6)
        np.testing.assert_allclose(im.t, poses[c][1], atol=1e-6)
    assert [t for t in m.tracks if t] == [t for t in reader(str(tmp_path)).tracks if t]


@pytest.mark.parametrize("binary", [False, True])
def test_ply_round_trip_and_cross_read(tmp_path, rng, binary):
    pts = rng.standard_normal((200, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (200, 3)).astype(np.uint8)
    tply.save_ply(str(tmp_path / "a.ply"), pts, cols, binary=binary)
    p1, c1 = tply.load_ply(str(tmp_path / "a.ply"))
    p2, c2 = jply.load_ply(str(tmp_path / "a.ply"))
    np.testing.assert_allclose(p1, pts, atol=1e-6 if binary else 1e-6 + 5e-7)
    np.testing.assert_array_equal(c1, cols)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(c1, c2)
    jply.save_ply(str(tmp_path / "b.ply"), pts, cols, binary=binary)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_cameras_ply_matches_jax(tmp_path, rng):
    import jax.numpy as jnp

    from recon3d_tpu.camera import CameraPose as JaxPose
    from recon3d_tpu.camera import stack_poses as jax_stack

    _, poses, *_ = _random_model(rng)
    tply.save_cameras_ply(str(tmp_path / "t.ply"), stack_poses(
        [CameraPose(R=torch.from_numpy(R), t=torch.from_numpy(t)) for R, t in poses.values()]))
    jply.save_cameras_ply(str(tmp_path / "j.ply"), jax_stack(
        [JaxPose(R=jnp.asarray(R), t=jnp.asarray(t)) for R, t in poses.values()]))
    a, ca = tply.load_ply(str(tmp_path / "t.ply"))
    b, cb = tply.load_ply(str(tmp_path / "j.ply"))
    np.testing.assert_allclose(a, b, atol=2e-6)  # centres |C| ~ 2; 6-decimal ASCII
    np.testing.assert_array_equal(ca, cb)


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("torch_io_imgs")
    scene = render_views(n_views=3, image_size=(64, 80), arc_step=0.15)
    for i, img in enumerate(scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(d / f"v_{i:02d}.png")
    return str(d), scene["K"]


@pytest.mark.parametrize("dist", [None, np.array([-0.15, 0.04, 0.002, -0.001, 0.0], np.float32)])
def test_load_image_set_matches_jax(png_dir, dist):
    d, K = png_dir
    t = load_image_set(d, camera_from_numpy(K, dist), max_size=1600, device="cpu")
    j = jax_load_image_set(d, JaxCamera.from_matrix(K, dist), max_size=1600)
    assert t.names == j.names == list_images(d)
    np.testing.assert_allclose(t.camera.K.numpy(), np.asarray(j.camera.K), atol=1e-6)
    np.testing.assert_array_equal(t.camera.dist.numpy(), np.asarray(j.camera.dist))
    np.testing.assert_array_equal(t.sizes, j.sizes)
    # Undistorted pixels make a uint8 round trip on both sides: a sample
    # within float32 rounding of an integer boundary may truncate one level
    # apart, so allow one level (1/255) on at most 0.5% of values.
    diff = np.abs(t.color - j.color)
    assert diff.max() <= 1.0 / 255 + 1e-6
    assert (diff > 1e-6).mean() <= 0.005
    np.testing.assert_allclose(t.gray, np.asarray(j.gray), atol=1.0 / 255 + 1e-6)


def test_load_image_set_rescales_K_and_refuses_cuda_without_gpu(png_dir):
    d, K = png_dir
    t = load_image_set(d, camera_from_numpy(K), max_size=40, device="cpu")
    j = jax_load_image_set(d, JaxCamera.from_matrix(K), max_size=40)
    np.testing.assert_allclose(t.camera.K.numpy(), np.asarray(j.camera.K), atol=1e-6)
    np.testing.assert_array_equal(t.color, j.color)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            load_image_set(d, camera_from_numpy(K, np.full(5, 0.01, np.float32)),
                           device="cuda")


def test_config_and_camera_conversion():
    cfg = JaxConfig.fast().replace(
        patchmatch=JaxPatchMatchConfig(scale=0.5, num_iterations=2, patch_size=7)
    )
    port = config_from_dict(dataclasses.asdict(cfg))
    assert isinstance(port, ReconstructionConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.sfm.pnp_thresholds_px == (8.0, 10.0, 12.0)
    assert config_from_dict(dataclasses.asdict(JaxConfig())) == ReconstructionConfig()
    with pytest.raises(KeyError):
        config_from_dict({"patchmatch": {"no_such_field": 1}})

    jc = JaxCamera.create(100.0, 110.0, 31.5, 23.5, dist=[0.1, 0, 0, 0, 0])
    pc = camera_from_numpy(np.asarray(jc.K), np.asarray(jc.dist))
    assert isinstance(pc, Camera)
    np.testing.assert_array_equal(pc.K.numpy(), np.asarray(jc.K))
    np.testing.assert_allclose(pc.scaled(0.25).K.numpy(), np.asarray(jc.scaled(0.25).K), atol=1e-6)
    np.testing.assert_array_equal(
        Camera.create(100.0, 110.0, 31.5, 23.5).K.numpy(),
        np.asarray(JaxCamera.create(100.0, 110.0, 31.5, 23.5).K),
    )
    p = poses_from_numpy(np.stack([np.eye(3)] * 2), np.ones((2, 3)), ids=[4, 7])
    assert sorted(p) == [4, 7] and p[7][0].dtype == np.float32
