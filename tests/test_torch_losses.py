"""ex4dgs_tpu_torch image losses against the JAX package's.

`l1_loss`, `l2_loss`, `psnr`, `ssim` (the mean, the per-pixel map, and the
closed-form gradient for both inputs) and `combined_loss` on the same seeded
images, at an even size and an odd one (the blur's zero padding at the
edges). The losses agree to 1e-6 absolute; the SSIM map pixel by pixel to
2e-6 (the port blurs with a depthwise convolution, the JAX package with
shifted adds: the same taps summed in another order, and the variance
sigma^2 = blur(x^2) - mu^2 cancels a few of those ulps into the map);
gradients to 1e-9 absolute on cotangents of a mean over ~10^4 values
(largest gradient ~1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu.ops import losses as jl
from ex4dgs_tpu_torch.ops import losses as tl

torch.set_num_threads(2)

SHAPES = [(48, 64, 3), (37, 53, 3)]


def _images(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", SHAPES, ids=["48x64", "37x53"])
def test_losses_match_jax(shape):
    a, b = _images(shape)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("l1_loss", "l2_loss", "psnr", "ssim"):
        got = float(getattr(tl, name)(ta, tb))
        want = float(getattr(jl, name)(ja, jb))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6 if name == "psnr" else 0,
                                   err_msg=name)
    got_map = tl.ssim(ta, tb, reduce=False).numpy()
    want_map = np.asarray(jl.ssim(ja, jb, reduce=False))
    assert got_map.shape == want_map.shape == shape
    np.testing.assert_allclose(got_map, want_map, atol=2e-6, rtol=0)
    (gl, gl1), (wl, wl1) = tl.combined_loss(ta, tb), jl.combined_loss(ja, jb)
    np.testing.assert_allclose([float(gl), float(gl1)], [float(wl), float(wl1)], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=["48x64", "37x53"])
def test_ssim_gradient_matches_jax(shape):
    """The closed-form backward of SSIMMap for both inputs against
    jax.grad through the JAX package's custom VJP, for the mean SSIM and for
    a weighted sum of the map (a cotangent that is not uniform)."""
    a, b = _images(shape, seed=1)
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)

    def jloss(x, y):
        return jl.ssim(x, y) + (jl.ssim(x, y, reduce=False) * w).mean()

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    loss = tl.ssim(ta, tb) + (tl.ssim(ta, tb, reduce=False) * torch.tensor(w)).mean()
    got = torch.autograd.grad(loss, [ta, tb])
    for g, wv, name in zip(got, want, ("img1", "img2")):
        wv = np.asarray(wv)
        assert np.abs(wv).max() > 1e-5, name
        np.testing.assert_allclose(g.numpy(), wv, atol=1e-9, rtol=0, err_msg=name)


def test_ssim_gradient_of_a_ground_truth_is_not_computed():
    """Training differentiates only the prediction: the ground truth's blur
    stack is skipped, and the prediction's gradient is unchanged."""
    a, b = _images((24, 32, 3))
    ta = torch.tensor(a, requires_grad=True)
    (g_only,) = torch.autograd.grad(tl.ssim(ta, torch.tensor(b)), [ta])
    tb = torch.tensor(b, requires_grad=True)
    g_both = torch.autograd.grad(tl.ssim(ta, tb), [ta, tb])[0]
    assert torch.equal(g_only, g_both)


def test_combined_loss_gradient_matches_jax():
    a, b = _images((48, 64, 3), seed=3)
    want = jax.grad(lambda x: jl.combined_loss(x, jnp.asarray(b))[0])(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    (got,) = torch.autograd.grad(tl.combined_loss(ta, torch.tensor(b))[0], [ta])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=0)
