"""K1 (bilinear warp) in the PyTorch port against the JAX reference.

On the CPU the port's wrapper runs the plain PyTorch version; it is held to
the JAX gather formula and to the Pallas kernel in interpret mode at its
exact level. The kernel itself is compared with the plain version on the
card by tests/test_torch_warp_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recon3d_tpu.ops.image import bilinear_sample as jax_bilinear_sample
from recon3d_tpu.ops.warp_pallas import bilinear_sample_pallas
from recon3d_tpu_torch.kernels import warp
from recon3d_tpu_torch.ops.image import (
    bilinear_sample,
    bilinear_sample_auto,
    sample_planes,
)

# Values: the same float32 gather formula on both sides; 1e-6 covers a
# different rounding of the four-term sum (inputs lie in [0, 1]).
ATOL = 1e-6


def _edge_case_inputs(rng):
    """tests/test_image_ops.py:153-170: NaN, inf, the exact far corner and
    points outside the image."""
    img = rng.random((37, 53)).astype(np.float32)
    coords = (rng.random((5, 64, 2)) * np.array([60.0, 45.0]) - 4.0).astype(
        np.float32
    )
    coords[0, 0] = (np.nan, 3.0)
    coords[0, 1] = (np.inf, 3.0)
    coords[0, 2] = (52.0, 36.0)  # exact corner (W-1, H-1)
    coords[0, 3] = (-np.inf, 1.0)
    coords[0, 4] = (2.0, np.nan)
    return img, coords


def _large_inputs(rng):
    """tests/test_image_ops.py:172-185: 4,096 points inside a 48x64 image."""
    img = rng.random((48, 64)).astype(np.float32)
    coords = (rng.random((4096, 2)) * np.array([63.0, 47.0])).astype(np.float32)
    return img, coords


@pytest.mark.parametrize("make", [_edge_case_inputs, _large_inputs])
def test_plain_matches_jax_gather_and_pallas(rng, make):
    img, coords = make(rng)
    a, va = bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords))
    g, vg = jax_bilinear_sample(jnp.asarray(img), jnp.asarray(coords))
    p, vp = bilinear_sample_pallas(
        jnp.asarray(img), jnp.asarray(coords), interpret=True, exact=True
    )
    for ref, vref in ((g, vg), (p, vp)):
        np.testing.assert_array_equal(va.numpy(), np.asarray(vref))
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_fill_and_color_image(rng):
    """Invalid samples carry `fill`; an (H, W, C) image samples each channel
    like the JAX gather (channels as planes sharing the coordinates)."""
    img = rng.random((20, 30, 3)).astype(np.float32)
    coords = (rng.random((7, 9, 2)) * np.array([36.0, 26.0]) - 3.0).astype(np.float32)
    a, va = bilinear_sample_auto(torch.from_numpy(img), torch.from_numpy(coords), fill=-2.0)
    g, vg = jax_bilinear_sample(jnp.asarray(img), jnp.asarray(coords), fill=-2.0)
    assert a.shape == (7, 9, 3) and va.shape == (7, 9)
    np.testing.assert_array_equal(va.numpy(), np.asarray(vg))
    np.testing.assert_allclose(a.numpy(), np.asarray(g), atol=ATOL, rtol=0)
    assert (a.numpy()[~va.numpy()] == -2.0).all()


def test_batched_planes_match_per_plane(rng):
    """One batched call over N planes (own and shared coordinates) equals N
    single-plane calls."""
    planes = rng.random((4, 12, 17)).astype(np.float32)
    coords = (rng.random((4, 5, 6, 2)) * np.array([19.0, 14.0]) - 1.0).astype(np.float32)
    out, valid = sample_planes(torch.from_numpy(planes), torch.from_numpy(coords))
    assert out.shape == (4, 5, 6) and valid.shape == (4, 5, 6)
    shared, vshared = sample_planes(torch.from_numpy(planes), torch.from_numpy(coords[:1]))
    for n in range(4):
        a, va = bilinear_sample(torch.from_numpy(planes[n]), torch.from_numpy(coords[n]))
        np.testing.assert_array_equal(out[n].numpy(), a.numpy())
        np.testing.assert_array_equal(valid[n].numpy(), va.numpy())
        b, vb = bilinear_sample(torch.from_numpy(planes[n]), torch.from_numpy(coords[0]))
        np.testing.assert_array_equal(shared[n].numpy(), b.numpy())
        np.testing.assert_array_equal(vshared[n].numpy(), vb.numpy())


@pytest.mark.parametrize("shared", [False, True])
def test_plain_on_misaligned_coords_and_odd_count_matches_jax(rng, shared):
    """The layout the kernel takes on its scalar path (coordinates 8 but not
    16 bytes past an allocation, M = 1,001 points, not a multiple of 4)
    gives the JAX gather's samples through the wrapper on the CPU, own or
    shared points alike."""
    N, M, Nc = 3, 1001, 1 if shared else 3
    planes = rng.random((N, 23, 31)).astype(np.float32)
    xy = (rng.random((Nc, M, 2)) * np.array([36.0, 28.0]) - 2.5).astype(np.float32)
    xy[0, :3] = [(np.nan, 1.0), (30.0, 22.0), (np.inf, 0.0)]
    buf = torch.zeros(Nc * M * 2 + 2)
    coords = buf[2:].view(Nc, M, 2)
    coords.copy_(torch.from_numpy(xy))
    assert coords.is_contiguous() and coords.data_ptr() % 16 == 8
    assert warp.plan_launch(N, 23, 31, Nc, M, 8).vec == 1
    out, valid = warp.tent_warp(torch.from_numpy(planes), coords, fill=-1.0)
    assert out.shape == valid.shape == (N, M)
    for n in range(N):
        g, vg = jax_bilinear_sample(jnp.asarray(planes[n]), jnp.asarray(xy[0 if shared else n]),
                                    fill=-1.0)
        np.testing.assert_array_equal(valid[n].numpy(), np.asarray(vg))
        np.testing.assert_allclose(out[n].numpy(), np.asarray(g), atol=ATOL, rtol=0)


def test_wrapper_counts_plain_calls_on_cpu_and_checks_inputs(rng):
    planes = torch.from_numpy(rng.random((2, 8, 9)).astype(np.float32))
    coords = torch.zeros((2, 5, 2))
    warp.counts.reset()
    warp.tent_warp(planes, coords)
    assert (warp.counts.kernel, warp.counts.plain) == (0, 1)
    # only kernel launches are split by shape and variant
    assert not warp.counts.by_shape and not warp.counts.by_variant
    with pytest.raises(ValueError):  # variants are the kernel's; the CPU has one version
        warp.tent_warp(planes, coords, variant="plane")
    assert warp.shape_key(planes, coords[:1]) == "2x8x9/1x5"
    with pytest.raises(TypeError):
        warp.tent_warp(planes.double(), coords)
    with pytest.raises(ValueError):
        warp.tent_warp(planes, torch.zeros((3, 5, 2)))
    with pytest.raises(ValueError):
        warp.tent_warp(planes[0], coords)
    warp.counts.reset()


def test_plain_version_differentiates_on_the_cpu(rng):
    """On a CPU tensor tent_warp is the plain version and differentiates
    (the card's kernel refuses inputs that require grad, having no
    backward): the gradients of a weighted sum of samples with respect to
    the planes and the in-range points equal jax.grad of the JAX gather
    within 1e-5 of their magnitude."""
    import jax

    img = rng.random((2, 17, 23)).astype(np.float32)
    coords = (rng.random((1, 40, 2)) * np.array([21.5, 15.5])).astype(np.float32)
    w = rng.normal(size=(2, 40)).astype(np.float32)
    planes = torch.from_numpy(img).requires_grad_()
    pts = torch.from_numpy(coords).requires_grad_()
    out, _ = warp.tent_warp(planes, pts)
    (out * torch.from_numpy(w)).sum().backward()

    def ref(im, c):
        return sum(jnp.sum(jax_bilinear_sample(im[n], c[0])[0] * w[n]) for n in range(2))

    gi, gc = jax.jit(jax.grad(ref, argnums=(0, 1)))(jnp.asarray(img), jnp.asarray(coords))
    for got, r in ((planes.grad, gi), (pts.grad, gc)):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(got.numpy(), r, atol=1e-5 * np.abs(r).max())
