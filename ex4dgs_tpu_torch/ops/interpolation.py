"""Temporal interpolation of keyframed dynamic Gaussians.

Counterpart of `ex4dgs_tpu/ops/interpolation.py`: linear, cube
(Catmull-Rom), pchip and cubic_diff Hermite interpolation over the keyframe
axis of [P, K, D] arrays, and quaternion slerp with the reference's exact
1e-4 guards. A query at time t maps to t' = t + time_shift,
k = floor(t'/interval), dt = (t' mod interval)/interval.
"""
from __future__ import annotations

import numpy as np
import torch


def linear_interp(y0, y1, t):
    return y0 * (1.0 - t) + y1 * t


def _hermite(y_k, y_k1, m_k, m_k1, t):
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00 * y_k + h10 * m_k + h01 * y_k1 + h11 * m_k1


def cube_interp(y_km1, y_k, y_k1, y_k2, t):
    """Cubic Hermite with central-difference/2 tangents (the default "cube")."""
    m_k = (y_k1 - y_km1) / 2.0
    m_k1 = (y_k2 - y_k) / 2.0
    return _hermite(y_k, y_k1, m_k, m_k1, t)


def pchip_interp(y_km1, y_k, y_k1, y_k2, t):
    """Monotone (PCHIP-style) Hermite."""
    zero = torch.zeros_like(y_k)
    d0 = (y_k1 - y_k) * (y_k - y_km1)
    m_k = torch.where(d0 > 0, d0 / (y_k1 - y_km1) * 2.0, zero)
    d1 = (y_k2 - y_k1) * (y_k1 - y_k)
    m_k1 = torch.where(d1 > 0, d1 / (y_k2 - y_k) * 2.0, zero)
    return _hermite(y_k, y_k1, m_k, m_k1, t)


def cubic_diff_interp(y_k, y_k1, yd_k, yd_k1, t):
    """Hermite with explicitly parameterized tangents."""
    return _hermite(y_k, y_k1, yd_k, yd_k1, t)


def quat_slerp(q0, q1, t):
    """Slerp with the reference's guards: dot clamped to +-(1-1e-4), omega
    and sin(omega) floored at 1e-4, weights renormalized, and a fallback to
    q0 where the blend vanishes."""
    q0 = q0 / torch.linalg.norm(q0, dim=-1, keepdim=True)
    q1 = q1 / torch.linalg.norm(q1, dim=-1, keepdim=True)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    d = torch.clamp(d, -1 + 1e-4, 1 - 1e-4)
    omega = torch.clamp_min(torch.arccos(d), 1e-4)
    s_omega = torch.clamp_min(torch.sin(omega), 1e-4)
    p0 = torch.sin((1.0 - t) * omega) / s_omega
    p1 = torch.sin(t * omega) / s_omega
    p_sum = torch.clamp_min(p0 + p1, 1e-4)
    p0 = p0 / p_sum
    p1 = p1 / p_sum
    ret = q0 * p0 + q1 * p1
    ret = torch.where(torch.sum(torch.abs(ret), dim=-1, keepdim=True) > 1e-4, ret, q0)
    return ret / torch.linalg.norm(ret, dim=-1, keepdim=True)


def time_bigaussian(center, var, t, var_min: float):
    """Two-sided temporal opacity envelope: 1 inside the [P, 2] window
    `center`, a Gaussian falloff of width exp(var) + var_min/2.36 outside."""
    # amin, not min: at a tie (center[:, 0] == center[:, 1]) its gradient is
    # shared between the two ends, as jnp.min's is.
    m = torch.amin(t - center, dim=1)
    v = torch.where(torch.any(t > center, dim=1), var[:, 1], var[:, 0])
    opa = torch.exp(-(m ** 2) / (torch.exp(v) + var_min / 2.36) ** 2)
    inside = (center[:, 0] - t) * (center[:, 1] - t) < 0
    return torch.where(inside, torch.ones_like(opa), opa)


def keyframe_index(t, time_shift: float, interval: float) -> int:
    """floor((t + time_shift) / interval) of a host timestamp, in float32
    with the correctly rounded operations of the JAX package's op."""
    tt = np.float32(t) + np.float32(time_shift)
    return int(np.floor(tt / np.float32(interval)))


def keyframe_coords(t: torch.Tensor, time_shift: float, interval: float, t_host=None):
    """Scene timestamp t (0-d float32 tensor) -> (keyframe index k,
    fractional offset as a 0-d tensor). With `t_host`, t's value as a host
    number, k is a Python int computed on the host, and the keyframes are
    sliced; without it k is a 0-d int64 tensor on t's device, computed there
    with the same float32 operations, and t is never read back."""
    tt = t + time_shift
    if t_host is not None:
        k = keyframe_index(t_host, time_shift, interval)
    else:
        # a tensor divisor: a host number would be multiplied in as its
        # reciprocal on the GPU, which can land on the wrong side of a
        # keyframe boundary
        k = torch.floor(tt / torch.full_like(tt, interval)).long()
    dt = torch.remainder(tt, interval) / interval
    return k, dt


def gather_keyframes(y: torch.Tensor, k, offsets: tuple[int, ...]):
    """y[:, k+o] for each o in offsets, with numpy-style negative indices. A
    keyframe outside the K axis reads as NaN, as the JAX package's gather
    fills it: the dynamic points then fail the frustum test and vanish.
    k a Python int slices; k a 0-d tensor gathers on the device with one
    index_select of the consecutive offsets, reading nothing back."""
    K = y.shape[1]
    if not isinstance(k, torch.Tensor):
        return tuple(y[:, k + o] if -K <= k + o < K
                     else torch.full_like(y[:, 0], float("nan")) for o in offsets)
    if list(offsets) != list(range(offsets[0], offsets[0] + len(offsets))):
        raise ValueError(f"a device index gathers consecutive offsets, got {offsets}")
    idx = k + torch.arange(offsets[0], offsets[0] + len(offsets), device=y.device)
    inside = (idx >= -K) & (idx < K)
    cols = y.index_select(1, torch.where(inside, torch.remainder(idx, K), 0))
    cols = torch.where(inside.view((1, -1) + (1,) * (y.dim() - 2)), cols, float("nan"))
    return cols.unbind(1)


def interp_keyframes(kind: str, y, k, dt, y_d=None):
    """Positional interpolation over keyframe axis 1 of y [P, K, D].
    kind: 'linear' | 'cube' | 'pchip' | 'cubic_diff' (needs tangents y_d)."""
    if kind == "linear":
        y0, y1 = gather_keyframes(y, k, (0, 1))
        return linear_interp(y0, y1, dt)
    if kind == "cube":
        return cube_interp(*gather_keyframes(y, k, (-1, 0, 1, 2)), dt)
    if kind == "pchip":
        return pchip_interp(*gather_keyframes(y, k, (-1, 0, 1, 2)), dt)
    if kind == "cubic_diff":
        if y_d is None:
            raise ValueError("cubic_diff needs a tangent array y_d")
        y0, y1 = gather_keyframes(y, k, (0, 1))
        yd0, yd1 = gather_keyframes(y_d, k, (0, 1))
        return cubic_diff_interp(y0, y1, yd0, yd1, dt)
    raise NotImplementedError(f"unknown interp kind: {kind}")


def interp_quat_keyframes(kind: str, y, k, dt):
    """Rotation interpolation between adjacent keyframes: 'lerp' or 'slerp'."""
    y0, y1 = gather_keyframes(y, k, (0, 1))
    if kind == "lerp":
        return linear_interp(y0, y1, dt)
    if kind == "slerp":
        return quat_slerp(y0, y1, dt)
    raise NotImplementedError(f"unknown rot interp kind: {kind}")
