"""The yardstick of 4D-GS (Wu et al., CVPR 2024): the operations and bytes
its HexPlane kernels, its deformation MLP and its training step need,
counted as `counts.py` counts (each multiply, add or subtract one, exp,
sqrt, floor and reciprocals none; each input byte read once and each output
written once), so every figure is a lower bound. Compositing is
`counts.py`'s, on the pairs the family's census counts; the projection is
`counts_fourdgs.PROJECT`.

The configuration's widths (`configs/n3v_hexplane.json`): 2 scales of 6
planes of 16 channels, an MLP of width 128 from 32 features to five heads
of 3, 3, 4, 1 and 48 outputs. Per Gaussian and view, the field's forward:
  * the box normalisation, 3 x (subtract, multiply, subtract) = 9;
  * per plane, per axis u = (c + 1) / 2 (R - 1) (3) and w, 1 - w (2): 10,
    over 12 planes = 120;
  * per plane and channel the bilinear sample (6 multiplies, 3 adds): 9 x
    16 x 12 = 1,728;
  * the products of a scale's six samples, 5 x 16 x 2 = 160.
Its backward recomputes the forward's samples (1,728 + 120), then per plane
and channel: the product of the other five samples and g (5), the four
corners' weights and their shares of g (8; the atomic adds 4 more), the
sample's derivative along each of its two axes (2 x 5) times g and du/dc
(4) and added to the point's share (2): 33 x 16 x 12 = 6,336; the 16
channels' sums of the 4 coordinates (60); the normalisation's chain (3).
The bytes, each read or written once: the points' own, forward the
coordinates (16 B) and the features (128 B), backward the coordinates, the
features' cotangent and the coordinates' gradient (160 B); and each view's
launch reads the planes (4 B an element: 9.46 MB at the configuration's
widths) and the backward's writes their gradients (4 B more). At the cell's
300,000 Gaussians a view the planes are 9.46 MB beside the points' 43.2 MB
forward, and 18.9 MB beside 48.0 MB backward.

The MLP: 32 x 128 + 5 x (128 x 128) + 128 x (3 + 3 + 4 + 1 + 48) = 93,568
multiply-adds a Gaussian-view, two FLOPs each forward; its backward takes
the inputs' and the weights' gradients, twice the forward.
"""
from __future__ import annotations

from . import counts, counts_fourdgs

FIELD_FWD = 9 + 120 + 1728 + 160
FIELD_BWD = 1728 + 120 + 33 * 16 * 12 + 60 + 3
FIELD_FWD_BYTES = 16 + 128
FIELD_BWD_BYTES = 16 + 128 + 16
MLP_MACS = 32 * 128 + 5 * 128 * 128 + 128 * (3 + 3 + 4 + 1 + 48)
MLP_FWD = 2 * MLP_MACS
MLP_BWD = 2 * MLP_FWD
# Per Gaussian-view around the field: the five offsets added (59), the
# quaternion normalised (11), the sigmoid's product (1), the covariance
# from scale and rotation (60, as counts.py counts it) and SH degree 3 from
# the deformed mean (137); their gradients at least as much again.
DEFORM_REST = 59 + 11 + 1 + 60 + 137
# Per L1 pixel and channel: subtract, abs and sum (2), the gradient (1).
L1_PIXEL_CHANNEL = 3
# Per plane element: the smoothness term's two differences, square and sum
# (5) and its gradient (5); a time plane's |1 - P| (3) counted alike.
REG_ELEMENT = 10
ADAM_ELEMENT = counts_fourdgs.ADAM_ELEMENT


def field_fwd_work(w: dict):
    """(FLOPs, bytes) of the forward HexPlane kernel over the census `w`'s
    deformed Gaussian-views, the planes read once a view."""
    return (FIELD_FWD * w["deformed"],
            FIELD_FWD_BYTES * w["deformed"] + 4 * w["plane_elements"] * w["views"])


def field_bwd_work(w: dict):
    """(FLOPs, bytes) of the backward HexPlane kernel, the planes read and
    their gradients written once a view."""
    return (FIELD_BWD * w["deformed"],
            FIELD_BWD_BYTES * w["deformed"] + 8 * w["plane_elements"] * w["views"])


def mlp_flops(w: dict) -> int:
    """FLOPs of the deformation MLP, forward and backward."""
    return (MLP_FWD + MLP_BWD) * w["deformed"]


def step_flops(w: dict) -> int:
    """FLOPs of one training step from its census `w` (summed over its
    views): compositing forward and backward, the field and the MLP and
    their gradients, the activations, covariance and colour and theirs,
    the projection and its gradient, the L1 loss, the regularizers, Adam."""
    return (counts.composite_fwd_work(w["pairs"], 0, 0, w["pixels"], True)[0]
            + counts.composite_bwd_work(w["pairs"], 0, 0, w["pixels"])[0]
            + (FIELD_FWD + FIELD_BWD + 2 * DEFORM_REST) * w["deformed"] + mlp_flops(w)
            + 2 * counts_fourdgs.PROJECT * w["visible"]
            + L1_PIXEL_CHANNEL * 3 * w["pixels"] + REG_ELEMENT * w["plane_elements"]
            + ADAM_ELEMENT * w["param_elements"])
