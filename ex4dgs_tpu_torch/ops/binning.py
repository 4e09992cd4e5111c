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

With `tight_cull` (KernelConfig.tight_cull, JAX's `TIGHT_CULL`) an
instance whose alpha a box bound proves below the compositing floor over
its whole tile is sent to the sentinel tile before the sort: it keeps its
slot and sorts past the last tile, `total` is unchanged, and only the
tiles' ranges shrink. The bound is JAX's operation for operation, so both
packages cull the same instances.

Slab mode (`row0`, `rows`, `total_tiles`) bins only the tile rows
[row0, row0 + rows): the unit the tile-sharded compositing distributes
(rendering.py::composite_projected_sharded). A Gaussian counts its full
rect width times its rows inside the slab, its rect starts at its first
row in the slab, and the result's tile ids are slab-local (tile 0 is the
first tile of row row0). The packed key keeps the depth bits of the whole
grid's `total_tiles`, so a slab's tiles hold their instances in the order
the unsharded binning gives them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .compositing import ALPHA_MIN
from .projection import Projected


class Binning(NamedTuple):
    order: torch.Tensor  # [capacity] int32 Gaussian index per sorted instance
    tile_id: torch.Tensor  # [capacity] int32 tile per sorted instance (T = pad)
    tile_start: torch.Tensor  # [num_tiles] int32
    tile_stop: torch.Tensor  # [num_tiles] int32
    total: torch.Tensor  # [] int32 true instance count (may exceed capacity)
    cum: torch.Tensor  # [P] int32 inclusive prefix of per-Gaussian counts
    counts: torch.Tensor  # [P] int32 tiles touched per Gaussian
    # [capacity] int32 each sorted instance's slot in the expansion (prefix)
    # order before the sort; the port's own field (JAX's Binning has none),
    # read by the pack VJP (ops/rasterize_cuda.py::PackSorted)
    slot: torch.Tensor


def bin_gaussians(proj: Projected, grid_x: int, grid_y: int, capacity: int,
                  exact_depth_sort: bool = False, tight_cull: bool = False,
                  tile_x: int = 32, tile_y: int = 16, row0: int | None = None,
                  rows: int | None = None, total_tiles: int | None = None) -> Binning:
    """Bin Gaussians into depth-sorted per-tile instance lists (tile_x x
    tile_y pixel tiles; the shape matters only to `tight_cull`). With
    `row0` and `rows`, only the slab of tile rows [row0, row0 + rows) is
    binned (module docstring); `total_tiles` defaults to the whole grid."""
    dev = proj.depth.device
    i32 = dict(dtype=torch.int32, device=dev)
    slab = row0 is not None
    if slab:
        if rows is None:
            raise ValueError("slab binning needs `rows` with `row0`")
        num_tiles = rows * grid_x
        key_tiles = grid_x * grid_y if total_tiles is None else total_tiles
        # rows of each rect inside the slab, times the rect's full width
        y0c = torch.clamp_min(proj.rect_min[:, 1], row0)
        rows_in = torch.clamp_min(torch.clamp_max(proj.rect_max[:, 1], row0 + rows) - y0c, 0)
        width = torch.clamp_min(proj.rect_max[:, 0] - proj.rect_min[:, 0], 1)
        counts = torch.where((proj.tiles_touched > 0) & (rows_in > 0), rows_in * width,
                             torch.zeros_like(rows_in)).to(torch.int32)
        rect_y = torch.clamp(y0c - row0, 0, rows)  # slab-local first row
    else:
        num_tiles = key_tiles = grid_x * grid_y
        counts = proj.tiles_touched.to(torch.int32)
        rect_y = proj.rect_min[:, 1]
    P = proj.tiles_touched.shape[0]
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = cum[-1] if P > 0 else torch.zeros((), **i32)

    slots = torch.arange(capacity, **i32)
    # Slot -> source Gaussian. Zero-count Gaussians put their marker on the
    # same slot as their successor, so the cumsum steps over them; markers
    # at or past the capacity are dropped.
    # (A dropped marker adds 0 at the last slot: a boolean-mask select of
    # the kept markers would read their count back to the host.)
    excl = (cum - counts).long()
    keep = excl < capacity
    marks = torch.zeros(capacity, **i32)
    marks.index_add_(0, excl.clamp_max(capacity - 1), keep.to(torch.int32))
    gauss_c = (torch.cumsum(marks, 0, dtype=torch.int32) - 1).clamp(0, max(P - 1, 0))
    g = gauss_c.long()
    # A slot's position within its Gaussian's run. The JAX package takes a
    # running max of the run starts instead, a TPU workaround for gathers;
    # on the GPU PyTorch's int32 cummax is a slow single-block scan and the
    # gather is cheap. Slots past `total` get the sentinel tile below, so
    # their `local` is never read.
    local = slots - excl[g].to(torch.int32)

    rx = proj.rect_min[g, 0]
    ry = rect_y[g]
    rw = torch.clamp_min(proj.rect_max[g, 0] - rx, 1)
    dy = torch.div(local, rw, rounding_mode="floor")
    dx = local - dy * rw
    in_range = slots < total
    tile = (ry + dy) * grid_x + (rx + dx)
    if tight_cull:
        cull = _culled(proj, g, rx + dx, ry + dy + (row0 if slab else 0), tile_x, tile_y)
        tile = torch.where(cull, torch.full_like(tile, num_tiles), tile)
    tile = torch.where(in_range, tile, torch.full_like(slots, num_tiles))  # sentinel sorts last

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
        depth_bits = 31 - key_tiles.bit_length()
        key = (tile << depth_bits) | (depth.view(torch.int32) >> (31 - depth_bits))
        key = torch.where(in_range, key, torch.full_like(key, 2**31 - 1))
        key_s, perm = torch.sort(key, stable=True)
        tile_s = torch.where(key_s == 2**31 - 1, torch.full_like(key_s, num_tiles),
                             key_s >> depth_bits)
        start = torch.searchsorted(key_s, tile_ids << depth_bits, side="left")
        stop = torch.searchsorted(key_s, (tile_ids + 1) << depth_bits, side="left")
    return Binning(order=gauss_c[perm], tile_id=tile_s, tile_start=start.to(torch.int32),
                   tile_stop=stop.to(torch.int32), total=total, cum=cum, counts=counts,
                   slot=perm.to(torch.int32))


def _culled(proj: Projected, g, col, row, tile_x: int, tile_y: int) -> torch.Tensor:
    """[capacity] bool: the instances (Gaussian g in tile (col, row)) whose
    alpha is below ALPHA_MIN everywhere in the tile's pixel box enlarged by
    a 1 px margin (JAX's ops/binning.py:150-201, in its order of
    operations). The least of the conic's PSD quadratic over a box is 0 if
    the centre lies inside, else it lies on an edge, where the free
    coordinate takes its clamped unconstrained optimum. The 1e-3 relative
    slack covers the kernels' own alpha rounding; a NaN bound compares
    False and the instance is kept."""
    mx, my = proj.xy[g, 0], proj.xy[g, 1]
    ca, cb, cc = proj.conic[g, 0], proj.conic[g, 1], proj.conic[g, 2]
    op = (proj.opacity * proj.valid)[g]
    margin = 1.0
    u0 = col.to(torch.float32) * float(tile_x) - margin - mx
    u1 = u0 + (float(tile_x) + 2.0 * margin)
    v0 = row.to(torch.float32) * float(tile_y) - margin - my
    v1 = v0 + (float(tile_y) + 2.0 * margin)
    inside = (u0 <= 0) & (u1 >= 0) & (v0 <= 0) & (v1 >= 0)
    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)

    def quad(u, v):
        return ca * u * u + 2.0 * cb * u * v + cc * v * v

    def q_ufix(u):
        return quad(u, torch.minimum(torch.maximum(-cb * u / cc_s, v0), v1))

    def q_vfix(v):
        return quad(torch.minimum(torch.maximum(-cb * v / ca_s, u0), u1), v)

    qmin = torch.minimum(torch.minimum(q_ufix(u0), q_ufix(u1)),
                         torch.minimum(q_vfix(v0), q_vfix(v1)))
    qmin = torch.where(inside, torch.zeros_like(qmin), torch.clamp_min(qmin, 0.0))
    bound = op * torch.exp(-0.5 * qmin)
    return bound < ALPHA_MIN * (1.0 - 1e-3)


def required_capacity(total: int, granularity: int = 65536) -> int:
    """Round an instance count up to a bucketed capacity."""
    return max(granularity, ((int(total) + granularity - 1) // granularity) * granularity)
