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


def tile_offsets(off: torch.Tensor, grid_x: int, grid_y: int, tile_x: int,
                 tile_y: int) -> torch.Tensor:
    """Per-pixel subpixel offsets, an [H, W, 2] image, as per-tile blocks
    [num_tiles, tile_y*tile_x, 2] in tile_pixels' order, zero on the pixels
    past the image's right and bottom edges (the JAX package pads them so)."""
    height, width = off.shape[:2]
    off = torch.nn.functional.pad(off, (0, 0, 0, grid_x * tile_x - width,
                                        0, grid_y * tile_y - height))
    return (off.reshape(grid_y, tile_y, grid_x, tile_x, 2).permute(0, 2, 1, 3, 4)
            .reshape(grid_x * grid_y, tile_y * tile_x, 2).contiguous())


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
                    tile_x: int = 32, tile_y: int = 16,
                    subpixel_offset=None) -> comp.RenderOutputs:
    """Render [H, W] outputs via the tile decomposition. subpixel_offset:
    optional f32 [H, W, 2]; pixel (x, y) is then evaluated at
    (x + off[y, x, 0], y + off[y, x, 1]). The offsets are data: no gradient
    reaches them."""
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    xy, conic, opac, feats, gid = gather_sorted(proj, colors, flow, binning)
    pixf = tile_pixels(grid_x, grid_y, tile_x, tile_y, xy.device)
    if subpixel_offset is not None:
        pixf = pixf + tile_offsets(subpixel_offset.detach(), grid_x, grid_y, tile_x, tile_y)
    carry = blend_tiles(pixf, xy, conic, opac, feats, gid, binning.tile_start,
                        binning.tile_stop, chunk=chunk)
    out = comp.finalize(carry, bg, max_depth)

    def to_image(arr):
        return comp.tiles_to_image(arr, grid_y, grid_x, tile_y, tile_x, height, width)

    return comp.RenderOutputs(*(to_image(a) for a in out))
