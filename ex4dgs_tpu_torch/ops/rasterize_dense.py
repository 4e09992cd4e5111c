"""Dense O(P * pixels) reference renderer: the exact oracle.

Counterpart of `ex4dgs_tpu/ops/rasterize_dense.py`. The same contribution
semantics as the tiled path, including the per-tile rect eligibility test
the reference inherits from its binning stage, but with no binning: every
pixel considers every Gaussian in global depth order. Autograd through it
is the gradient oracle. Only tests call it, and only small scenes fit.
"""
from __future__ import annotations

import torch

from . import compositing as comp
from .projection import Projected


def rasterize_dense(proj: Projected, colors, flow, *, width: int, height: int, bg,
                    max_depth: float, subpixel_offset=None, chunk: int = 0,
                    tile_x: int = 32, tile_y: int = 16) -> comp.RenderOutputs:
    """Render [H, W] outputs. colors, flow [P, 3]; bg [3]; subpixel_offset
    optional f32 [H, W, 2] (pixel (x, y) is evaluated at (x + off[y, x, 0],
    y + off[y, x, 1])). chunk > 0 blends the Gaussians in depth-ordered
    chunks of that size (peak memory H * W * chunk); tile_x x tile_y is the
    tile shape the rects were computed for."""
    P = proj.xy.shape[0]
    dev = proj.xy.device
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf), stable=True)
    xy = proj.xy[order]
    conic = proj.conic[order]
    valid = proj.valid[order]
    opac = torch.where(valid, proj.opacity[order], torch.zeros_like(proj.opacity[order]))
    rect_min = proj.rect_min[order]
    rect_max = proj.rect_max[order]
    feats = comp.make_features(colors[order], proj.depth[order], flow[order])
    ids = order.to(torch.int32)

    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    pixf = torch.stack([xs, ys], dim=-1).to(torch.float32)
    if subpixel_offset is not None:
        pixf = pixf + subpixel_offset.detach()
    tx = torch.div(xs, tile_x, rounding_mode="floor")[..., None]  # [H, W, 1]
    ty = torch.div(ys, tile_y, rounding_mode="floor")[..., None]

    carry = comp.init_carry((height, width), 8, dev)
    step = P if chunk <= 0 else chunk
    for s in range(0, P, step):
        sl = slice(s, min(s + step, P))
        in_rect = ((tx >= rect_min[sl, 0]) & (tx < rect_max[sl, 0])
                   & (ty >= rect_min[sl, 1]) & (ty < rect_max[sl, 1]))  # [H, W, G]
        carry = comp.blend_chunk(carry, pixf, xy[sl], conic[sl], opac[sl] * valid[sl],
                                 feats[sl], in_rect & valid[sl], ids[sl])
    return comp.finalize(carry, bg, max_depth)
