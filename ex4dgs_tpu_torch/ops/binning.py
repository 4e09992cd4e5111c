"""Tile binning: expand visible Gaussians into per-tile depth-sorted instance
lists in a fixed-capacity buffer.

Counterpart of `ex4dgs_tpu/ops/binning.py` (default path plus
`exact_depth_sort`), equal to it bit for bit:

  1. per-Gaussian tile counts -> inclusive prefix sum;
  2. each of `capacity` instance slots finds its source Gaussian: a step
     marker at each Gaussian's exclusive prefix position, then a cumsum;
  3. one stable sort on the packed 31-bit key
     [tile << DEPTH_BITS | depth-bits >> shift] (positive float bit patterns
     order like the floats; the low mantissa bits are cut, so ties within
     ~2^-10 relative depth blend in Gaussian order), or with
     `exact_depth_sort` the exact (tile, float depth) order;
  4. per-tile [start, stop) ranges by searchsorted.

Instances beyond `capacity` are dropped from the back of the prefix order;
`total` reports the true count so callers can detect the overflow.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import Projected


class Binning(NamedTuple):
    order: torch.Tensor  # [capacity] int32 Gaussian index per sorted instance
    tile_id: torch.Tensor  # [capacity] int32 tile per sorted instance (T = pad)
    tile_start: torch.Tensor  # [num_tiles] int32
    tile_stop: torch.Tensor  # [num_tiles] int32
    total: torch.Tensor  # [] int32 true instance count (may exceed capacity)
    cum: torch.Tensor  # [P] int32 inclusive prefix of per-Gaussian counts
    counts: torch.Tensor  # [P] int32 tiles touched per Gaussian


def bin_gaussians(proj: Projected, grid_x: int, grid_y: int, capacity: int,
                  exact_depth_sort: bool = False) -> Binning:
    """Bin Gaussians into depth-sorted per-tile instance lists."""
    dev = proj.depth.device
    i32 = dict(dtype=torch.int32, device=dev)
    num_tiles = grid_x * grid_y
    P = proj.tiles_touched.shape[0]
    counts = proj.tiles_touched.to(torch.int32)
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = cum[-1] if P > 0 else torch.zeros((), **i32)

    slots = torch.arange(capacity, **i32)
    # Slot -> source Gaussian. Zero-count Gaussians put their marker on the
    # same slot as their successor, so the cumsum steps over them; markers
    # at or past the capacity are dropped.
    excl = (cum - counts).long()
    keep = excl < capacity
    marks = torch.zeros(capacity, **i32)
    marks.index_add_(0, excl[keep], torch.ones_like(excl[keep], dtype=torch.int32))
    gauss_c = (torch.cumsum(marks, 0, dtype=torch.int32) - 1).clamp(0, max(P - 1, 0))
    g = gauss_c.long()
    # A slot's position within its Gaussian's run. The JAX package takes a
    # running max of the run starts instead, a TPU workaround for gathers;
    # on the GPU PyTorch's int32 cummax is a slow single-block scan and the
    # gather is cheap. Slots past `total` get the sentinel tile below, so
    # their `local` is never read.
    local = slots - excl[g].to(torch.int32)

    rx = proj.rect_min[g, 0]
    ry = proj.rect_min[g, 1]
    rw = torch.clamp_min(proj.rect_max[g, 0] - rx, 1)
    dy = torch.div(local, rw, rounding_mode="floor")
    dx = local - dy * rw
    in_range = slots < total
    tile = torch.where(in_range, (ry + dy) * grid_x + (rx + dx),
                       torch.full_like(slots, num_tiles))  # sentinel sorts last

    tile_ids = torch.arange(num_tiles, **i32)
    depth = proj.depth[g]
    if exact_depth_sort:
        # Lexicographic stable sort as two stable passes: the minor key
        # (depth) first, then the major key (tile).
        by_depth = torch.sort(depth, stable=True).indices
        by_tile = torch.sort(tile[by_depth], stable=True).indices
        perm = by_depth[by_tile]
        tile_s = tile[perm]
        start = torch.searchsorted(tile_s, tile_ids, side="left")
        stop = torch.searchsorted(tile_s, tile_ids, side="right")
    else:
        depth_bits = 31 - num_tiles.bit_length()
        key = (tile << depth_bits) | (depth.view(torch.int32) >> (31 - depth_bits))
        key = torch.where(in_range, key, torch.full_like(key, 2**31 - 1))
        key_s, perm = torch.sort(key, stable=True)
        tile_s = torch.where(key_s == 2**31 - 1, torch.full_like(key_s, num_tiles),
                             key_s >> depth_bits)
        start = torch.searchsorted(key_s, tile_ids << depth_bits, side="left")
        stop = torch.searchsorted(key_s, (tile_ids + 1) << depth_bits, side="left")
    return Binning(order=gauss_c[perm], tile_id=tile_s, tile_start=start.to(torch.int32),
                   tile_stop=stop.to(torch.int32), total=total, cum=cum, counts=counts)


def required_capacity(total: int, granularity: int = 65536) -> int:
    """Round an instance count up to a bucketed capacity."""
    return max(granularity, ((int(total) + granularity - 1) // granularity) * granularity)
