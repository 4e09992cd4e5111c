"""Image losses and metrics: L1, L2, windowed SSIM, PSNR.

Counterpart of `ex4dgs_tpu/ops/losses.py`, on channel-last [H, W, C] images:
SSIM uses an 11-tap Gaussian window (sigma 1.5) applied separably with zero
same-padding, C1 = 0.01^2, C2 = 0.03^2, and its gradient is the closed form
of the JAX package (three blurs per input). The blur is a depthwise
convolution; TF32 is off (the package's precision policy), since a
reduced-precision blur makes the SSIM variance noisier than C2.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .. import upload


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio over the whole image."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The normalised 1-D window on `device`, uploaded once (without
    blocking: upload) and never evicted: a CUDA graph of the training step
    reads it by its address."""
    g = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)]
    s = sum(g)
    return upload(torch.tensor([v / s for v in g], dtype=dtype), device)


def _depthwise_blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] with zero same-padding: along H,
    then along W, as depthwise convolutions."""
    c = img.shape[-1]
    half = window_size // 2
    g = _gaussian_window(window_size, sigma, img.dtype, img.device)
    x = img.permute(2, 0, 1)[None]  # [1, C, H, W]
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(half, 0), groups=c)
    x = F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, half), groups=c)
    return x[0].permute(1, 2, 0)


_C1 = 0.01**2
_C2 = 0.03**2


def _ssim_stats(img1, img2, window_size, sigma):
    # One blur for all five moment maps, stacked on the channel axis.
    c = img1.shape[-1]
    b = _depthwise_blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1),
                        window_size, sigma)
    return b[..., :c], b[..., c:2 * c], b[..., 2 * c:3 * c], b[..., 3 * c:4 * c], b[..., 4 * c:]


def _ssim_map_from_stats(mu1, mu2, s11, s22, s12):
    a1 = 2 * mu1 * mu2 + _C1
    a2 = 2 * (s12 - mu1 * mu2) + _C2
    b1 = mu1 * mu1 + mu2 * mu2 + _C1
    b2 = (s11 - mu1 * mu1) + (s22 - mu2 * mu2) + _C2
    return (a1 * a2) / (b1 * b2), (a1, a2, b1, b2)


class SSIMMap(torch.autograd.Function):
    """The per-pixel SSIM map with the closed-form backward of the JAX
    package's `_ssim_map_bwd`: with S = A1 A2 / (B1 B2) the cotangents of
    the five moment maps are blurred back (the window is symmetric, so the
    blur is its own transpose), in two stacks keyed by the input that
    consumes them, so a ground truth that needs no gradient costs no blur."""

    @staticmethod
    def forward(ctx, img1, img2, window_size, sigma):
        stats = _ssim_stats(img1, img2, window_size, sigma)
        s, coefs = _ssim_map_from_stats(*stats)
        ctx.save_for_backward(img1, img2, *stats, *coefs, s)
        ctx.window = (window_size, sigma)
        return s

    @staticmethod
    def backward(ctx, g):
        img1, img2, mu1, mu2, _s11, _s22, _s12, a1, a2, b1, b2, s = ctx.saved_tensors
        window_size, sigma = ctx.window
        gs = g * s
        c_s11 = -gs / b2
        c_s12 = 2 * gs / a2
        c = img1.shape[-1]
        d1 = d2 = None
        if ctx.needs_input_grad[0]:
            c_mu1 = 2 * gs * (mu2 / a1 - mu2 / a2 - mu1 / b1 + mu1 / b2)
            b = _depthwise_blur(torch.cat([c_mu1, c_s11, c_s12], dim=-1), window_size, sigma)
            d1 = b[..., :c] + 2 * img1 * b[..., c:2 * c] + img2 * b[..., 2 * c:]
        if ctx.needs_input_grad[1]:
            c_mu2 = 2 * gs * (mu1 / a1 - mu1 / a2 - mu2 / b1 + mu2 / b2)
            b = _depthwise_blur(torch.cat([c_mu2, c_s11, c_s12], dim=-1), window_size, sigma)
            d2 = b[..., :c] + 2 * img2 * b[..., c:2 * c] + img1 * b[..., 2 * c:]
        return d1, d2, None, None


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11, sigma: float = 1.5,
         reduce: bool = True) -> torch.Tensor:
    """SSIM of [H, W, C] images; reduce=False returns the per-pixel map."""
    ssim_map = SSIMMap.apply(img1, img2, window_size, sigma)
    return ssim_map.mean() if reduce else ssim_map


def combined_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    """((1 - lambda) L1 + lambda (1 - SSIM), L1): the training loss."""
    ll1 = l1_loss(pred, gt)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(pred, gt)), ll1
