"""LPIPS (Learned Perceptual Image Patch Similarity) in PyTorch.

Counterpart of `ex4dgs_tpu/eval/lpips_jax.py`, a re-implementation of the
reference's lpipsPyTorch: input scaling layer, backbone deep features at the
standard tap points, per-layer unit normalisation over channels, squared
difference, the learned 1x1 linear calibration, spatial mean, sum over
layers. The convolutions are `F.conv2d` in float32 with TF32 off (the
package's precision policy, set on import of `ex4dgs_tpu_torch`), so the
metric stays comparable with the reference's.

The backbone and linear weights are not bundled. They load from
`lpips_alex.npz` / `lpips_vgg.npz` (made by `tools/convert_lpips_weights.py`
on a machine with torchvision and the `lpips` package) in the directory that
`EX4DGS_LPIPS_WEIGHTS` names (default ~/.cache/ex4dgs/lpips). Without them
`LPIPS` returns None: callers must not report a feature distance as LPIPS.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# ImageNet-stat scaling layer (lpipsPyTorch/modules/networks.py:101-110)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# ("conv", out_ch, kernel, stride, pad), ("tap",) after the relu, ("pool", k, s)
ALEX_LAYERS = [
    ("conv", 64, 11, 4, 2), ("tap",), ("pool", 3, 2),
    ("conv", 192, 5, 1, 2), ("tap",), ("pool", 3, 2),
    ("conv", 384, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",),
]
# VGG16 features with taps at relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG_LAYERS = [
    ("conv", 64, 3, 1, 1), ("conv", 64, 3, 1, 1), ("tap",), ("pool", 2, 2),
    ("conv", 128, 3, 1, 1), ("conv", 128, 3, 1, 1), ("tap",), ("pool", 2, 2),
    ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1),
    ("tap",), ("pool", 2, 2),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",), ("pool", 2, 2),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",),
]
LAYERS = {"alex": ALEX_LAYERS, "vgg": VGG_LAYERS}


def weights_dir() -> str:
    return os.environ.get("EX4DGS_LPIPS_WEIGHTS", os.path.expanduser("~/.cache/ex4dgs/lpips"))


def load_weights(net: str) -> dict | None:
    """The {conv{i}_w, conv{i}_b, lin{i}_w} arrays of `net` if present."""
    path = os.path.join(weights_dir(), f"lpips_{net}.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return {k: z[k] for k in z.files}


def features(x: torch.Tensor, layers, weights: dict) -> list[torch.Tensor]:
    """The backbone on x [N, 3, H, W]; returns the tapped (post-relu) maps."""
    taps = []
    ci = 0
    for spec in layers:
        if spec[0] == "conv":
            _, _, _, stride, pad = spec
            x = F.relu(F.conv2d(x, weights[f"conv{ci}_w"], weights[f"conv{ci}_b"],
                                stride=stride, padding=pad))
            ci += 1
        elif spec[0] == "pool":
            x = F.max_pool2d(x, spec[1], spec[2])
        elif spec[0] == "tap":
            taps.append(x)
    return taps


def unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # networks.py normalize_activation: x / (||x||_2 over channels + eps)
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def prep(im: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] in [0, 1] -> the scaled [1, 3, H, W] backbone input. The
    values stay in [0, 1]: the reference feeds render.py's clamped [0, 1]
    tensors straight into BaseNet.z_score (render.py:80-81,
    networks.py:50-53) without the upstream [-1, 1] rescale."""
    shift = torch.tensor(_SHIFT, dtype=im.dtype, device=im.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=im.dtype, device=im.device).view(1, 3, 1, 1)
    return (im.permute(2, 0, 1)[None] - shift) / scale


def lpips_fn(img_a: torch.Tensor, img_b: torch.Tensor, layers, weights: dict) -> torch.Tensor:
    """LPIPS distance of two [H, W, 3] float images in [0, 1]; `weights` are
    tensors on the images' device."""
    fa = features(prep(img_a), layers, weights)
    fb = features(prep(img_b), layers, weights)
    total = torch.zeros((), dtype=img_a.dtype, device=img_a.device)
    for i, (a, b) in enumerate(zip(fa, fb)):
        d = (unit_normalize(a) - unit_normalize(b)) ** 2  # [1, C, H, W]
        lin = weights[f"lin{i}_w"].view(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * lin, dim=1))  # 1x1 conv + avg
    return total


class LPIPS:
    """LPIPS evaluator of one net on `device` (cuda unless told otherwise).
    Without weights it returns None and `error` says why; the reference's
    first choice, the `lpips` package, is not used: the port depends on no
    package of finished models."""

    def __init__(self, net: str = "alex", device=None):
        if net not in LAYERS:
            raise ValueError(f"unknown LPIPS net {net!r}")
        self.net = net
        self.device = resolve_device(device)
        self.layers = LAYERS[net]
        w = load_weights(net)
        self.weights = None if w is None else {
            k: torch.as_tensor(v, dtype=torch.float32, device=self.device) for k, v in w.items()}
        self.error = None if w is not None else (
            f"lpips_{net} unavailable: no weights in {weights_dir()} (run "
            f"tools/convert_lpips_weights.py and set EX4DGS_LPIPS_WEIGHTS)")

    @property
    def available(self) -> bool:
        return self.weights is not None

    def __call__(self, pred, gt) -> float | None:
        """pred, gt: [H, W, 3] in [0, 1], tensors or arrays."""
        if self.weights is None:
            return None
        a = torch.as_tensor(pred, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(gt, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return float(lpips_fn(a, b, self.layers, self.weights))
