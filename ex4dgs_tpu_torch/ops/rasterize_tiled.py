"""Tiled rasterizer in plain torch: the portable oracle.

Counterpart of `ex4dgs_tpu/ops/rasterize_tiled.py`: every tile blends its
depth-ordered instance range with the shared compositing core, all tiles
advancing in lockstep over fixed-size chunks (masked beyond their own
range). It runs on any device and is the base of the forward-compositing
kernel's plain version (ops/rasterize_cuda.py).
"""
from __future__ import annotations

import torch

from . import compositing as comp
from .binning import Binning
from .projection import Projected


def gather_sorted(proj: Projected, colors, flow, binning: Binning):
    """Per-instance data in sorted (tile, depth) order: xy, conic, opacity,
    the blendable features [r, g, b, depth, one, fx, fy, fz] and the
    Gaussian id of each instance."""
    g = binning.order.long().clamp(0, proj.xy.shape[0] - 1)
    opac = proj.opacity * proj.valid
    feats = comp.make_features(colors[g], proj.depth[g], flow[g])
    return proj.xy[g], proj.conic[g], opac[g], feats, binning.order


def tile_pixels(grid_x: int, grid_y: int, tile_x: int, tile_y: int, device) -> torch.Tensor:
    """Pixel coordinates per tile: [num_tiles, tile_y*tile_x, 2] (x, y)."""
    ty, tx = torch.meshgrid(torch.arange(grid_y, device=device),
                            torch.arange(grid_x, device=device), indexing="ij")
    py, px = torch.meshgrid(torch.arange(tile_y, device=device),
                            torch.arange(tile_x, device=device), indexing="ij")
    x = tx.reshape(-1, 1) * tile_x + px.reshape(1, -1)
    y = ty.reshape(-1, 1) * tile_y + py.reshape(1, -1)
    return torch.stack([x, y], dim=-1).to(torch.float32)


def blend_tiles(pixf, xy, conic, opac, feats, gid, starts, stops, *,
                chunk: int) -> comp.BlendCarry:
    """Blend each tile's instance range [starts[t], stops[t]) of the sorted
    per-instance arrays into its pixels pixf [T, S, 2], `chunk` instances at
    a time. The loop stops at the longest range: a fully masked chunk changes
    no state."""
    capacity = xy.shape[0]
    longest = int((stops - starts).max().item()) if starts.numel() else 0
    dev = xy.device
    lanes = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
    carry = comp.init_carry(tuple(pixf.shape[:2]), feats.shape[-1], dev)
    for j in range(-(-longest // chunk)):
        idx = starts[:, None] + j * chunk + lanes  # [T, C]
        ok = idx < stops[:, None]
        idx_c = idx.clamp(0, capacity - 1).long()
        # Lanes past a tile's range read its successor's (or the tail's) rows;
        # zero their features so a non-finite row there cannot reach the
        # accumulators through a zero weight.
        f = torch.where(ok[..., None], feats[idx_c], torch.zeros((), device=dev))
        carry = comp.blend_chunk(carry, pixf, xy[idx_c][:, None], conic[idx_c][:, None],
                                 opac[idx_c][:, None], f[:, None], ok[:, None],
                                 gid[idx_c][:, None])
    return carry


def rasterize_tiled(proj: Projected, colors, flow, binning: Binning, *, width: int,
                    height: int, bg, max_depth: float, chunk: int = 128,
                    tile_x: int = 32, tile_y: int = 16) -> comp.RenderOutputs:
    """Render [H, W] outputs via the tile decomposition."""
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    xy, conic, opac, feats, gid = gather_sorted(proj, colors, flow, binning)
    pixf = tile_pixels(grid_x, grid_y, tile_x, tile_y, xy.device)
    carry = blend_tiles(pixf, xy, conic, opac, feats, gid, binning.tile_start,
                        binning.tile_stop, chunk=chunk)
    out = comp.finalize(carry, bg, max_depth)

    def to_image(arr):
        return comp.tiles_to_image(arr, grid_y, grid_x, tile_y, tile_x, height, width)

    return comp.RenderOutputs(*(to_image(a) for a in out))
