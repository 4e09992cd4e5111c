"""Evaluation metric suite: PSNR, SSIM (two variants), LPIPS (alex + vgg).

Counterpart of `ex4dgs_tpu/eval/metrics.py`, mirroring render.py:76-81 in
the reference:
  * `psnr`, `ssim` — the training PSNR and torch-style SSIM
    (`ops/losses.py`), on tensors on the render's device;
  * `ssim_skimage` — skimage.metrics.structural_similarity semantics
    (gaussian_weights=True, sigma 1.5, sample covariance N/(N-1),
    valid-region crop), in numpy/scipy float64 on the host, the JAX
    package's code line for line;
  * `LPIPS` — the learned metric when its weights are present
    (`eval/lpips.py`), else None: no proxy is reported under its name.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from ..ops.losses import psnr as _psnr
from ..ops.losses import ssim as _ssim
from .lpips import LPIPS  # noqa: F401  (the evaluator; None without weights)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> float:
    return float(_psnr(pred, gt))


def ssim(pred: torch.Tensor, gt: torch.Tensor) -> float:
    with torch.no_grad():
        return float(_ssim(pred, gt))


def ssim_skimage(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """skimage.metrics.structural_similarity with the reference's settings
    (render.py:78: gaussian_weights=True, channel_axis=-1, data_range=1).

    Differences from the torch-style `ssim` above: truncate=3.5 gaussian
    (radius 5 -> 11x11), *sample* covariance normalisation NP/(NP-1), and
    the mean taken over the valid region only (a (win-1)/2 = 5 pixel border
    crop), not over zero-padded convolutions.
    """
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    sigma, truncate = 1.5, 3.5
    r = int(truncate * sigma + 0.5)  # 5
    win = 2 * r + 1  # 11
    NP = win * win
    cov_norm = NP / (NP - 1.0)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    def f(a):
        return gaussian_filter(a, sigma=sigma, truncate=truncate)

    vals = []
    for c in range(pred.shape[-1]):
        X, Y = pred[..., c], gt[..., c]
        ux, uy = f(X), f(Y)
        uxx, uyy, uxy = f(X * X), f(Y * Y), f(X * Y)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
            (ux * ux + uy * uy + C1) * (vx + vy + C2)
        )
        vals.append(S[r:-r, r:-r].mean())  # crop the filter-radius border
    return float(np.mean(vals))
