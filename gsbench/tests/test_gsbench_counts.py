"""The yardstick on frames small enough to count by hand."""
import math

import torch

from gsbench import counts
from gsbench import reference as R

CFG = {"tile": [32, 16], "exact_sort": False}
CAM = {"width": 32, "height": 16}


def _screen(xy, opacity, sigma=2.0):
    """Splats with isotropic conics, all valid, in one 32x16 tile."""
    n = len(xy)
    inv = 1.0 / sigma ** 2
    f64 = dict(dtype=torch.float64)
    return R.Screen(xy=torch.tensor(xy, **f64), conic=torch.tensor([[inv, 0.0, inv]] * n, **f64),
                    opacity=torch.tensor(opacity, **f64), rgb=torch.full((n, 3), 0.5, **f64),
                    depth=torch.arange(1, n + 1, **f64),
                    rect=torch.tensor([[0, 0, 1, 1]] * n), valid=torch.ones(n, dtype=torch.bool),
                    radius=torch.full((n,), 3.0 * sigma, **f64))


def _by_hand(xy, opacity, sigma=2.0):
    """(contributing, applied) counted pixel by pixel, front to back."""
    contributing = applied = 0
    for py in range(16):
        for px in range(32):
            T = 1.0
            for (x, y), o in zip(xy, opacity):
                if T < R.T_EPS:
                    break
                power = -0.5 * ((x - px) ** 2 + (y - py) ** 2) / sigma ** 2
                alpha = min(o * math.exp(power), R.ALPHA_MAX)
                if alpha < R.ALPHA_MIN:
                    continue
                contributing += 1
                if T * (1 - alpha) < R.T_EPS:
                    T = 0.0
                    break
                applied += 1
                T *= 1 - alpha
    return contributing, applied


def test_pairs_of_one_splat():
    xy, op = [[15.5, 7.5]], [0.8]
    _, pairs, _ = R.composite(_screen(xy, op), CFG, CAM, torch.zeros(3, dtype=torch.float64))
    assert pairs == _by_hand(xy, op)
    assert pairs[0] == pairs[1] > 0


def test_pairs_stop_where_a_pixel_latches():
    """Three near-opaque splats on one spot: the third takes the
    transmittance below 1e-4 where all three reach 0.99, so there it
    contributes and is not applied."""
    xy, op = [[15.5, 7.5]] * 3, [1.0] * 3
    _, pairs, _ = R.composite(_screen(xy, op, sigma=30.0), CFG, CAM,
                           torch.zeros(3, dtype=torch.float64))
    contributing, applied = _by_hand(xy, op, sigma=30.0)
    assert pairs == (contributing, applied)
    assert contributing - applied > 0


def test_work_of_a_hand_counted_frame():
    pairs, inst, splats, pixels = (300, 200), 5, 3, 512
    assert counts.composite_fwd_work(pairs, inst, splats, pixels, True) == (
        12 * 300 + 9 * 200 + 6 * 512, 4 * 5 + 36 * 3 + 16 * 512)
    assert counts.composite_fwd_work(pairs, inst, splats, pixels, False)[1] == (
        4 * 5 + 36 * 3 + 12 * 512)
    assert counts.composite_bwd_work(pairs, inst, splats, pixels) == (
        64 * 200 + 5 * 512, 4 * 5 + 72 * 3 + 16 * 512)
    assert counts.least_seconds(67e12, 0) == 1.0
    assert counts.least_seconds(0, 3.35e12) == 1.0
    assert counts.frame_flops(pairs, pixels, 2, 1) == (
        12 * 300 + 9 * 200 + 6 * 512 + 304 * 2 + 344 * 1)
    assert counts.step_flops(pairs, pixels, 2, 1, 10) == (
        12 * 300 + 9 * 200 + 6 * 512 + 64 * 200 + 5 * 512 + 2 * (304 * 2 + 344)
        + 382 * 3 * 512 + 14 * 10)
