"""The yardstick of 4D Gaussian Splatting (Yang et al.): the operations and
bytes its slicing kernels and its training step need, counted as
`counts.py` counts (each multiply, add or subtract one, a division one,
exp, sqrt, cos and reciprocals none; each input byte read once and each
output written once), so every figure is a lower bound. Compositing is
`counts.py`'s, on the pairs the family's census counts.

Per Gaussian and view, at SH degree 3 and time degree 2 (48 feature rows
of 3 channels), the slice's forward:
  * unit quaternions: 2 x (4 squares, 3 adds, 4 divisions) = 22;
  * R = M_l M_r: 16 entries x (4 multiplies + 3 adds) = 112;
  * D = (m exp s)^2: 4 x 2 = 8;
  * Sigma = R D R^T, 10 distinct entries x (4 x 2 multiplies + 3 adds) = 110;
  * cov3d: 6 x (2 multiplies + 1 subtract) = 18;
  * the mean: dt, dt / v, 3 multiply-adds = 8; the marginal's exponent 3;
    sigmoid and the opacity product 2;
  * the direction: 3 subtracts, the norm 5, 3 divisions = 11; the basis
    30; the time weights (k = 1, 2) 3 each = 6;
  * F_j = sum_k w_k f_kj, 16 x 3 x 3 multiply-adds = 288; rgb = B . F, 16 x 3
    multiply-adds = 96; the offset and the clamp 6.
The backward recomputes the forward, then: the feature gradients w_k B_j
g (48 x 3 x 2 = 288), B's cotangent F_j . g (16 x 5 = 80), the basis'
Jacobian product (about 90), the direction's normalisation (15), the
opacity, mean and conditional terms (40), G R and the scaling gradients
(112 + 32 + 28 + 8), M_l's and M_r's gradients (2 x 112) and the
quaternions' (2 x (16 + 15)) = 979 more.
"""
from __future__ import annotations

from . import counts

SLICE_FWD = 22 + 112 + 8 + 110 + 18 + 8 + 3 + 2 + 11 + 30 + 6 + 288 + 96 + 6
SLICE_BWD = SLICE_FWD + 288 + 80 + 90 + 15 + 40 + 112 + 32 + 28 + 8 + 224 + 62
# Bytes per Gaussian and view: the nine parameters, 161 floats (644 B);
# the forward adds the mask (1 B) and writes mean, cov3d, alpha and rgb (13
# floats) and live (1 B); the backward reads the four cotangents (13 floats)
# and writes the 161 floats' gradients.
PARAM_FLOATS = 3 + 1 + 3 + 1 + 4 + 4 + 1 + 48 * 3
SLICE_FWD_BYTES = 4 * PARAM_FLOATS + 1 + 4 * 13 + 1
SLICE_BWD_BYTES = 4 * PARAM_FLOATS + 4 * 13 + 4 * PARAM_FLOATS
# Per visible Gaussian and view, the projection of a 3D covariance passed
# in (the view transform 24, EWA and the dilation's conic 77, as counts.py
# counts Ex4DGS's), and its gradient at least as much again.
PROJECT = 24 + 77
# Adam per parameter element: the two moments (3 + 4), the denominator
# (sqrt(nu) / sqrt(bias2) + eps: 2) and the update (mu / denom, times the
# step size, subtracted: 3).
ADAM_ELEMENT = 12


def slice_fwd_work(gaussians: int):
    """(FLOPs, bytes) of the forward slicing kernel over `gaussians`
    (Gaussian, view) rows."""
    return SLICE_FWD * gaussians, SLICE_FWD_BYTES * gaussians


def slice_bwd_work(gaussians: int):
    """(FLOPs, bytes) of the backward slicing kernel."""
    return SLICE_BWD * gaussians, SLICE_BWD_BYTES * gaussians


def step_flops(w: dict) -> int:
    """FLOPs of one training step from its census `w` (summed over its
    views): compositing forward and backward, the slice and its gradient,
    the projection and its gradient, the loss and its gradient, Adam."""
    return (counts.composite_fwd_work(w["pairs"], 0, 0, w["pixels"], True)[0]
            + counts.composite_bwd_work(w["pairs"], 0, 0, w["pixels"])[0]
            + (SLICE_FWD + SLICE_BWD) * w["gaussians"] + 2 * PROJECT * w["visible"]
            + counts.LOSS_PIXEL_CHANNEL * 3 * w["pixels"] + ADAM_ELEMENT * w["param_elements"])
