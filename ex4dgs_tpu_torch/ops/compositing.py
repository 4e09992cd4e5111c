"""Alpha-compositing core.

Counterpart of `ex4dgs_tpu/ops/compositing.py`: for a depth-ordered chunk of
Gaussians the blend weights w_i = alpha_i * prod_{j<i}(1 - alpha_j) are a
cumulative product along the Gaussian axis, and every accumulated output is
a weighted sum. Early termination (the reference's latch once
T*(1-alpha) < 1e-4) is the prefix mask `cum >= T_EPS`: the running product
never recovers once below it. The dominant contributor is the strictly
greatest weight, so the earliest instance in depth order wins ties.

Gradient semantics are the JAX package's, so autograd through this module
equals `jax.grad` through its oracle:
  * the 0.99 alpha clamp is straight-through (forward min, backward identity);
  * only color (features[..., :3]) reaches alpha through the blend weights;
    the aux features (depth, one, flow) are blended with detached weights;
  * the accumulated opacity `acc` is detached, also where it normalises
    depth and flow.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
T_SENTINEL = 1e30


class BlendCarry(NamedTuple):
    cum: torch.Tensor  # [...] running transmittance product (incl. post-latch)
    t_final: torch.Tensor  # [...] transmittance at last applied contribution
    accum: torch.Tensor  # [..., F] accumulated w-weighted features
    max_vis: torch.Tensor  # [...] max blend weight seen
    best_idx: torch.Tensor  # [...] int32 id of dominant contributor (-1 none)


def init_carry(pixel_shape: tuple[int, ...], num_features: int, device) -> BlendCarry:
    f32 = dict(dtype=torch.float32, device=device)
    return BlendCarry(
        cum=torch.ones(pixel_shape, **f32),
        t_final=torch.full(pixel_shape, T_SENTINEL, **f32),
        accum=torch.zeros((*pixel_shape, num_features), **f32),
        max_vis=torch.zeros(pixel_shape, **f32),
        best_idx=torch.full(pixel_shape, -1, dtype=torch.int32, device=device),
    )


def chunk_alpha(pixf, xy, conic, opacity, contrib_ok):
    """(alpha, m) of a chunk: m marks the instances that pass the power,
    alpha-floor and eligibility tests, alpha is the clamped alpha there and
    0 elsewhere. Shapes as in blend_chunk; results are [..., G]."""
    d = xy - pixf[..., None, :]
    dx, dy = d[..., 0], d[..., 1]
    power = -0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy) - conic[..., 1] * dx * dy
    alpha_raw = opacity * torch.exp(torch.clamp_max(power, 0.0))
    # Straight-through clamp; the forward value is exactly min(raw, 0.99).
    alpha_c = alpha_raw + (torch.clamp_max(alpha_raw, ALPHA_MAX) - alpha_raw).detach()
    m = contrib_ok & (power <= 0.0) & (alpha_c >= ALPHA_MIN)
    return torch.where(m, alpha_c, torch.zeros_like(alpha_c)), m


def blend_chunk(carry: BlendCarry, pixf, xy, conic, opacity, features, contrib_ok,
                ids) -> BlendCarry:
    """Blend one depth-ordered chunk of G Gaussians into the running carry.

    pixf [..., 2] pixel coordinates; xy [..., G, 2]; conic [..., G, 3];
    opacity [..., G]; features [..., G, F]; contrib_ok [..., G] bool;
    ids [..., G] int32. Gaussian data may broadcast across pixel dims."""
    alpha, m = chunk_alpha(pixf, xy, conic, opacity, contrib_ok)
    cum_in = carry.cum[..., None]
    cum = cum_in * torch.cumprod(1.0 - alpha, dim=-1)  # inclusive [..., G]
    cum_excl = torch.cat([cum_in, cum[..., :-1]], dim=-1)
    applied = m & (cum >= T_EPS)
    w = torch.where(applied, alpha * cum_excl, torch.zeros_like(alpha))
    w_sg = w.detach()

    # einsum broadcasts the size-1 pixel dim of `features` without copying
    # it. Color takes gradients through the weights, the aux features only
    # through themselves.
    accum = carry.accum + torch.cat([
        torch.einsum("...g,...gf->...f", w, features[..., :3]),
        torch.einsum("...g,...gf->...f", w_sg, features[..., 3:])], dim=-1)

    sentinel = torch.full_like(cum, T_SENTINEL)
    chunk_min = torch.amin(torch.where(applied, cum, sentinel), dim=-1)
    t_final = torch.minimum(carry.t_final, chunk_min)

    chunk_max, chunk_best = torch.max(w_sg, dim=-1)  # first index of the max
    chunk_id = torch.gather(ids.expand(w.shape), -1, chunk_best[..., None])[..., 0]
    better = chunk_max > carry.max_vis
    return BlendCarry(
        cum=cum[..., -1],
        t_final=t_final,
        accum=accum,
        max_vis=torch.where(better, chunk_max, carry.max_vis),
        best_idx=torch.where(better, chunk_id, carry.best_idx),
    )


class RenderOutputs(NamedTuple):
    color: torch.Tensor  # [..., 3] (background composited)
    depth: torch.Tensor  # [...] acc-normalized mean depth (far where empty)
    flow: torch.Tensor  # [..., 3] acc-normalized flow
    acc: torch.Tensor  # [...] accumulated opacity
    final_t: torch.Tensor  # [...] final transmittance
    idx: torch.Tensor  # [...] int32 dominant contributor id (-1 = none)


def final_transmittance(carry: BlendCarry) -> torch.Tensor:
    """t_final, or the running product where nothing was applied (it is
    then still 1)."""
    return torch.where(carry.t_final >= T_SENTINEL, carry.cum, carry.t_final)


def finalize(carry: BlendCarry, bg, max_depth: float) -> RenderOutputs:
    """Normalize the accumulators. Feature layout in accum:
    [r, g, b, depth, one (acc), fx, fy, fz]."""
    t_final = final_transmittance(carry)
    color = carry.accum[..., 0:3] + t_final[..., None] * bg
    acc = carry.accum[..., 4].detach()
    has = acc > 0.0
    denom = torch.where(has, acc, torch.ones_like(acc))
    depth = torch.where(has, carry.accum[..., 3] / denom, torch.full_like(acc, max_depth))
    flow = torch.where(has[..., None], carry.accum[..., 5:8] / denom[..., None],
                       torch.zeros_like(carry.accum[..., 5:8]))
    return RenderOutputs(color=color, depth=depth, flow=flow, acc=acc, final_t=t_final,
                         idx=carry.best_idx)


def make_features(colors, depth, flow):
    """Blendable per-Gaussian features [..., 8] = (rgb, depth, 1, flow)."""
    return torch.cat([colors, depth[..., None], torch.ones_like(depth[..., None]), flow],
                     dim=-1)


def tiles_to_image(arr: torch.Tensor, grid_y: int, grid_x: int, tile_y: int, tile_x: int,
                   height: int, width: int) -> torch.Tensor:
    """Per-tile pixel blocks [T, tile_y*tile_x, *ch] -> image [height, width, *ch]."""
    ch = arr.shape[2:]
    img = arr.reshape(grid_y, grid_x, tile_y, tile_x, *ch)
    img = img.movedim(2, 1).reshape(grid_y * tile_y, grid_x * tile_x, *ch)
    return img[:height, :width]
