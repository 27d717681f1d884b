"""Image ops of the PyTorch port against their JAX counterparts (CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.io import hostimg as jax_hostimg
from recon3d_tpu.ops import image as jimg
from recon3d_tpu_torch.io import hostimg
from recon3d_tpu_torch.ops import image as timg
from recon3d_tpu_torch.ops.linalg import sum_batch_invariant

# float32 weight-matrix and integral-image arithmetic, summed in another
# order than XLA's: 1e-5 absolute on values in [0, 1] (box sums of up to
# 121 pixels).
ATOL = 1e-5


@pytest.mark.parametrize("shape,out", [
    ((48, 64), (12, 16)),     # x4 down, antialiased (patchmatch.py:340-343)
    ((12, 16), (48, 64)),     # x4 up (patchmatch.py:190, :351)
    ((33, 47), (14, 20)),     # non-integer ratio
    ((3, 24, 32), (6, 8)),    # leading batch, as the source stack
    ((3, 30, 40), (60, 80)),  # x2 up of a batch: the rescue pass (pipeline.py:1561-1566)
])
def test_resize_matches_jax_image_resize(rng, shape, out):
    img = rng.random(shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), shape[:-2] + out, method="linear")
    got = timg.resize(torch.from_numpy(img), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [0, 1, 5, 512, 700])
def test_sum_batch_invariant_sums_each_row_alone(rng, n):
    """ops/linalg.sum_batch_invariant: the sum within float32 rounding, and
    each row of a batch summed bit for bit as in a batch of another size
    (the sums of resize and of the 8-point solver's normalisation)."""
    x = rng.standard_normal((6, n, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    got = sum_batch_invariant(t, 1)
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64).sum(1), rtol=0,
                               atol=1e-5 * max(n, 1))
    for lo, hi in ((0, 3), (3, 6), (2, 3)):
        assert torch.equal(sum_batch_invariant(t[lo:hi], 1), got[lo:hi])


@pytest.mark.parametrize("shape,out", [((5, 48, 64), (12, 16)), ((5, 12, 16), (48, 64)),
                                       ((5, 33, 47), (14, 20)), ((5, 30, 40), (30, 80))])
def test_resize_batch_invariant_matches_jax_and_its_batch(rng, shape, out):
    """resize_batch_invariant (the dense stages' resize): jax.image.resize
    within ATOL, and a plane resized alone equal to its row of the batch,
    bit for bit (each output adds its taps in a fixed order)."""
    img = rng.random(shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), shape[:-2] + out, method="linear")
    whole = timg.resize_batch_invariant(torch.from_numpy(img), out)
    np.testing.assert_allclose(whole.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    for v in range(shape[0]):
        one = timg.resize_batch_invariant(torch.from_numpy(img[v:v + 1]), out)
        assert torch.equal(one, whole[v:v + 1])


@pytest.mark.parametrize("size", [3, 7, 11])
def test_box_filter_matches_jax_cumsum_branch(rng, size):
    img = rng.random((30, 41)).astype(np.float32)
    ref = jimg.box_filter(jnp.asarray(img), size)   # CPU: the cumsum branch
    got = timg.box_filter(torch.from_numpy(img), size)
    # The two cumsums add in different orders; a window sum is a difference
    # of integral-image entries as large as img.sum(), so it may be off by
    # two float32 ulps of that total, divided by the smallest window count.
    r = size // 2
    tol = 2 * float(np.spacing(np.float32(img.sum()))) / (r + 1) ** 2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=max(tol, ATOL), rtol=0)
    batched = timg.box_filter(torch.from_numpy(np.stack([img, img * 0.5])), size)
    np.testing.assert_allclose(batched[1].numpy(), 0.5 * got.numpy(), atol=ATOL)


def test_rgb_to_gray_matches_jax(rng):
    img = rng.random((3, 24, 32, 3)).astype(np.float32)
    ref = jimg.rgb_to_gray(jnp.asarray(img))
    got = timg.rgb_to_gray(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


DIST = np.array([-0.12, 0.03, 0.001, -0.002, 0.004], np.float32)
K_IMG = np.array([[70.0, 0, 31.5], [0, 72.0, 23.5], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("shape", [(48, 64), (48, 64, 3)])
def test_undistort_image_matches_jax(rng, shape):
    img = rng.random(shape).astype(np.float32)
    ref = jimg.undistort_image(jnp.asarray(img), jnp.asarray(K_IMG), jnp.asarray(DIST))
    got = timg.undistort_image(torch.from_numpy(img), torch.from_numpy(K_IMG),
                               torch.from_numpy(DIST))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_undistort_batch_matches_per_image(rng):
    imgs = rng.random((3, 20, 24, 3)).astype(np.float32)
    K = torch.tensor([[30.0, 0, 11.5], [0, 30.0, 9.5], [0, 0, 1]])
    dist = torch.from_numpy(DIST)
    batch = timg.undistort_image(torch.from_numpy(imgs), K, dist)
    for v in range(3):
        one = timg.undistort_image(torch.from_numpy(imgs[v]), K, dist)
        np.testing.assert_array_equal(batch[v].numpy(), one.numpy())


def test_distort_points_and_remap_match_jax(rng):
    xy = (rng.random((50, 2)) - 0.5).astype(np.float32)
    ref = jimg.distort_points(jnp.asarray(xy), jnp.asarray(DIST))
    got = timg.distort_points(torch.from_numpy(xy), torch.from_numpy(DIST))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    img = rng.random((16, 20)).astype(np.float32)
    mx = (rng.random((5, 6)) * 22 - 1).astype(np.float32)
    my = (rng.random((5, 6)) * 18 - 1).astype(np.float32)
    ref = jimg.remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my))
    got = timg.remap(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_copied_host_helpers_match_the_jax_package(rng):
    """io/hostimg.py is copied verbatim: identical results."""
    img = rng.random((2, 48, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        hostimg.resize_batch_np(img, (12, 16)), jax_hostimg.resize_batch_np(img, (12, 16))
    )
    np.testing.assert_array_equal(
        hostimg.rgb_to_gray_np(img), jax_hostimg.rgb_to_gray_np(img)
    )
    # and the port's device resize agrees with the host one
    got = timg.resize(torch.from_numpy(img).permute(0, 3, 1, 2), (12, 16))
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), hostimg.resize_batch_np(img, (12, 16)),
        atol=1e-6,
    )
