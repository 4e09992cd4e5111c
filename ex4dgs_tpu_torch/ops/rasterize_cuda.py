"""Forward tile compositing on the GPU: packing, the kernel's wrapper, its
plain version, and the drop-in rasterizer.

Counterpart of the forward half of `ex4dgs_tpu/ops/rasterize_pallas.py`.
The sorted per-instance data is packed feature-major into data[16, capacity]
(rows as in the JAX package: 0-1 xy, 2-4 conic, 5 opacity, 6-8 rgb,
9 depth, 10-12 flow, 13 one, 14-15 zero), so a tile's instance range is a
contiguous column block of every row. The Gaussian ids travel in their own
int32 buffer `gid`: carried as float bits in a data row, ids below ~8.4M
would be denormals that a flush-to-zero erases.

`composite_tiles_fwd` launches the CUDA kernel (csrc/composite_fwd.cu) for
CUDA tensors and takes the plain version `composite_tiles_plain` for CPU
tensors; the accumulator channels of both are (r, g, b, depth, fx, fy, fz,
one) = data rows 6-13.
"""
from __future__ import annotations

import torch

from .. import kernels
from . import compositing as comp
from .binning import Binning
from .projection import Projected
from .rasterize_tiled import blend_tiles, tile_pixels

DATA_ROWS = 16
N_ACC = 8


def pack_sorted(proj: Projected, colors, flow, binning: Binning):
    """(data f32 [16, capacity], gid i32 [capacity]): per-instance rows in
    sorted order, and each instance's Gaussian id."""
    P = proj.xy.shape[0]
    opac = proj.opacity * proj.valid
    ones = torch.ones_like(opac)
    zeros = torch.zeros_like(opac)
    rows = torch.stack([
        proj.xy[:, 0], proj.xy[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        opac,
        colors[:, 0], colors[:, 1], colors[:, 2],
        proj.depth,
        flow[:, 0], flow[:, 1], flow[:, 2],
        ones, zeros, zeros,
    ], dim=0)  # [16, P]
    g = binning.order.long().clamp(0, P - 1)
    data = rows.index_select(1, g)  # feature-major [16, capacity], no transpose
    return data, binning.order.to(torch.int32).contiguous()


def composite_tiles_fwd(data, gid, starts, stops, *, grid_x: int, tile_x: int = 32,
                        tile_y: int = 16, track_idx: bool = True):
    """Composite every tile's instance range [starts[t], stops[t]) of the
    packed buffer. Returns accum f32 [T, P, 8], tfinal f32 [T, P, 1] and
    bestidx i32 [T, P, 1] (all -1 unless track_idx), P = tile_x * tile_y.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if data.device.type == "cpu":
        return composite_tiles_plain(data, gid, starts, stops, grid_x=grid_x,
                                     tile_x=tile_x, tile_y=tile_y, track_idx=track_idx)
    return kernels.composite_fwd(data, gid, starts, stops, grid_x=grid_x, tile_x=tile_x,
                                 tile_y=tile_y, track_idx=track_idx)


def composite_tiles_plain(data, gid, starts, stops, *, grid_x: int, tile_x: int = 32,
                          tile_y: int = 16, track_idx: bool = True, chunk: int = 64,
                          tile_batch: int = 1024):
    """The kernel's plain PyTorch version, same signature and outputs: the
    oracle's chunked blend (ops/rasterize_tiled.py) over the packed rows,
    `tile_batch` tiles at a time to bound the [tiles, pixels, chunk]
    intermediates."""
    dev = data.device
    T = starts.shape[0]
    npix = tile_x * tile_y
    rows = data[:14].t()  # [capacity, 14]
    xy, conic, opac, feats = rows[:, 0:2], rows[:, 2:5], rows[:, 5], rows[:, 6:14]
    pixf = tile_pixels(grid_x, T // grid_x, tile_x, tile_y, dev)  # [T, P, 2]

    accum = torch.empty((T, npix, N_ACC), dtype=torch.float32, device=dev)
    tfinal = torch.empty((T, npix, 1), dtype=torch.float32, device=dev)
    bestidx = torch.full((T, npix, 1), -1, dtype=torch.int32, device=dev)
    for b in range(0, T, tile_batch):
        s = slice(b, b + tile_batch)
        carry = blend_tiles(pixf[s], xy, conic, opac, feats, gid, starts[s], stops[s],
                            chunk=chunk)
        accum[s] = carry.accum
        tfinal[s] = comp.final_transmittance(carry)[..., None]
        if track_idx:
            bestidx[s] = carry.best_idx[..., None]
    return accum, tfinal, bestidx


def rasterize_tiled_cuda(proj: Projected, colors, flow, binning: Binning, *, width: int,
                         height: int, bg, max_depth: float, tile_x: int = 32,
                         tile_y: int = 16, track_idx: bool = True) -> comp.RenderOutputs:
    """Drop-in for ops.rasterize_tiled.rasterize_tiled that composites with
    the kernel (plain version on the CPU). track_idx=False skips the
    dominant-contributor bookkeeping; `idx` then comes back all -1."""
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    data, gid = pack_sorted(proj, colors, flow, binning)
    accum, tfinal, bestidx = composite_tiles_fwd(
        data, gid, binning.tile_start, binning.tile_stop, grid_x=grid_x, tile_x=tile_x,
        tile_y=tile_y, track_idx=track_idx)
    color = accum[..., 0:3] + tfinal * bg
    acc = accum[..., 7]
    has = acc > 0.0
    denom = torch.where(has, acc, torch.ones_like(acc))
    depth = torch.where(has, accum[..., 3] / denom, torch.full_like(acc, max_depth))
    flow_img = torch.where(has[..., None], accum[..., 4:7] / denom[..., None],
                           torch.zeros_like(accum[..., 4:7]))

    def timg(arr):
        return comp.tiles_to_image(arr, grid_y, grid_x, tile_y, tile_x, height, width)

    return comp.RenderOutputs(color=timg(color), depth=timg(depth), flow=timg(flow_img),
                              acc=timg(acc), final_t=timg(tfinal[..., 0]),
                              idx=timg(bestidx[..., 0]))
