"""The yardstick: the operations and bytes a frame or a training step
needs, and the H100's data-sheet peaks they are held against.

Operations are those of the algorithm's formulas, whatever implements
them: each multiply and each add or subtract counts one (a fused
multiply-add two), and exp, sqrt and reciprocals count nothing, so every
figure is a lower bound of the work. Compositing work is charged to the
(splat, pixel) pairs that these inputs need, counted by the model family's
`census` (Ex4DGS's: `reference.composite`): a pair contributes when its
pixel is still open and it passes the power and alpha tests, and is
applied when the pixel stays open after it. Bytes count each input read
once and each output written once, at the algorithm's least: a splat's
screen data once, one index per tile instance, a pixel's outputs once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W power limit.
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores, an FMA counted as two
PEAK_HBM_BYTES_S = 3.35e12

# Forward, per contributing pair: dx, dy (2); the power
# -0.5 (a dx^2 + c dy^2) - b dx dy (9); alpha = opacity * G (1).
FWD_CONTRIBUTING = 12
# Forward, per applied pair: T' = T (1 - alpha) (2); w = alpha T (1); the
# colour sum, 3 channels of w c + acc (6).
FWD_APPLIED = 9
# Forward, per pixel: the background term, 3 channels of T bg + acc (6).
FWD_PIXEL = 6
# Backward, per applied pair, back to front (the 3DGS rasterizer's
# backward): the alpha again (12); T restored from T' = T (1 - alpha)
# (2, the reciprocal uncounted); dL/dc = alpha T dL/dC (4); the colour
# behind, 3 channels of alpha c + (1 - alpha) behind (9); dL/dalpha =
# T (c - behind) . dL/dC less T_final / (1 - alpha) (bg . dL/dC)
# (8 + 1 + 3); dL/dG = opacity dL/dalpha, dL/dopacity = G dL/dalpha,
# dL/dpower = G dL/dG (3); the power's gradient in (dx, dy),
# -(a dx + b dy) and -(b dx + c dy), times dL/dpower (8), and in
# (a, b, c), -dx^2 / 2, -dx dy, -dy^2 / 2 from the products above, times
# dL/dpower (5); the per-splat sums of the 9 gradient rows (xy 2, conic 3,
# opacity 1, rgb 3).
BWD_APPLIED = 12 + 2 + 4 + 9 + 12 + 3 + 8 + 5 + 9
# Backward, per pixel: dL/dC . bg for the background term (5).
BWD_PIXEL = 5

# Per-splat work of one camera: position at t (static: xyz + disp t / T,
# 6; a dynamic splat's cubic Hermite, 4 taps x 3 + the basis, 26, and the
# slerp's blend and renormalisation, 20), the 3-D covariance R S S^T R^T
# from the quaternion (rotation 21, R S 9, M M^T 6 x 5 = 30), the view
# transform (2 x 12 = 24) and the EWA projection J W Sigma (J W)^T with the
# low-pass dilation and conic (J 4, T = J W 15, T Sigma T^T 3 x 15 = 45,
# dilation and determinants 10, conic 3), and SH degree 3 (direction 8,
# basis 30, 16 x 3 multiply-adds 96, offset 3).
SPLAT_STATIC_FWD = 6 + 60 + 24 + 77 + 137
SPLAT_DYNAMIC_FWD = 46 + 60 + 24 + 77 + 137
# Their gradients take at least the forward's operations again.
SPLAT_BWD_FACTOR = 1
# Per pixel and channel of the loss: L1 (2 forward, 1 backward); SSIM's
# three products (3), five blurred maps of two 11-tap passes (5 x 2 x 21),
# the SSIM formula (15) and its mean (1); the backward's three blurred
# cotangent maps (3 x 2 x 21), their terms (20) and the products' rules (4).
LOSS_PIXEL_CHANNEL = 2 + 1 + 3 + 210 + 15 + 1 + 126 + 20 + 4
# RAdam per parameter element: the two moments (3 + 4), the bias-corrected
# step (2), the rectified scale (3) and the update (2).
RADAM_ELEMENT = 14


def composite_fwd_work(pairs, instances: int, splats: int, pixels: int, training: bool):
    """(FLOPs, bytes) of forward compositing: pairs = (contributing,
    applied). Reads per instance an index (4 B), per visible splat xy,
    conic, opacity and rgb (36 B); writes per pixel rgb (12 B) and, for
    the training step's backward, the final transmittance (4 B)."""
    contributing, applied = pairs
    flops = FWD_CONTRIBUTING * contributing + FWD_APPLIED * applied + FWD_PIXEL * pixels
    nbytes = 4 * instances + 36 * splats + (16 if training else 12) * pixels
    return flops, nbytes


def composite_bwd_work(pairs, instances: int, splats: int, pixels: int):
    """(FLOPs, bytes) of backward compositing: reads the instance indices,
    each visible splat's screen data (36 B), each pixel's colour gradient
    and final transmittance (16 B); writes each visible splat's 9
    gradient rows (36 B)."""
    _, applied = pairs
    flops = BWD_APPLIED * applied + BWD_PIXEL * pixels
    nbytes = 4 * instances + 72 * splats + 16 * pixels
    return flops, nbytes


def splat_work(n_static: int, n_dynamic: int, training: bool) -> int:
    """FLOPs of the per-splat stages (and their gradients when training)."""
    f = SPLAT_STATIC_FWD * n_static + SPLAT_DYNAMIC_FWD * n_dynamic
    return f * (1 + SPLAT_BWD_FACTOR) if training else f


def step_flops(pairs, pixels: int, n_static: int, n_dynamic: int, param_elements: int) -> int:
    """FLOPs of one training step: compositing forward and backward, the
    per-splat stages and their gradients, the loss and its gradient, and
    RAdam over the active parameter elements."""
    return (composite_fwd_work(pairs, 0, 0, pixels, True)[0]
            + composite_bwd_work(pairs, 0, 0, pixels)[0]
            + splat_work(n_static, n_dynamic, True)
            + LOSS_PIXEL_CHANNEL * 3 * pixels + RADAM_ELEMENT * param_elements)


def frame_flops(pairs, pixels: int, n_static: int, n_dynamic: int) -> int:
    """FLOPs of one frame: the per-splat stages and forward compositing."""
    return composite_fwd_work(pairs, 0, 0, pixels, False)[0] + splat_work(n_static, n_dynamic,
                                                                          False)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the H100 could take: the larger of the operations at
    the float32 peak and the bytes at the HBM rate."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_S)
