"""Tile compositing on the GPU: packing, the two kernels' wrappers, their
plain versions, the autograd functions, and the drop-in rasterizer.

Counterpart of `ex4dgs_tpu/ops/rasterize_pallas.py`.
The sorted per-instance data is packed feature-major into data[16, capacity]
(rows as in the JAX package: 0-1 xy, 2-4 conic, 5 opacity, 6-8 rgb,
9 depth, 10-12 flow, 13 one, 14-15 zero), so a tile's instance range is a
contiguous column block of every row. The Gaussian ids travel in their own
int32 buffer `gid`: carried as float bits in a data row, ids below ~8.4M
would be denormals that a flush-to-zero erases.

`composite_tiles_fwd` launches the forward kernel (csrc/composite_fwd.cu)
for CUDA tensors and takes the plain version `composite_tiles_plain` for CPU
tensors; the accumulator channels of both are (r, g, b, depth, fx, fy, fz,
one) = data rows 6-13. `composite_tiles_bwd` does the same for the backward
kernel (csrc/composite_bwd.cu) and `composite_tiles_bwd_plain`.
`warp_cull_plain` (with `warp_boxes`) is the kernels' per-warp cull
(csrc/composite_common.cuh) in PyTorch, for the tests and chip_smoke.py's
pair counts; `tfinal_rel_err` is the relative tfinal check (TF_RTOL) that
holds the forward kernel to its plain version behind a small transmittance,
and `bwd_errors` the element-wise check (BWD_RTOL, BWD_ATOL) that holds the
backward kernel to its. `composite_tiles_bwd_walk` is the backward kernel's
twin: its arithmetic and its order of sums, which the kernel equals bit for
bit.

Subpixel offsets: every compositing function takes `offsets=None`, f32
[T, P, 2] per tile (`tile_offsets` cuts them from an [H, W, 2] image), and
evaluates pixel p of tile t at its centre plus offsets[t, p]: one rounded
add, then mean - pixel, in that order in the kernels, the plain versions
and the twin. They are data: CompositeTiles gives them no gradient (the
JAX package's custom VJP gives them a zero cotangent).

Slabs: every compositing function takes `tile0=0`, the grid index of
its first tile (JAX's `tids = t0 + arange`; a scalar, since JAX only ever
passes `arange` or `t0 + arange`). It moves the pixel coordinates and the
warp boxes to tiles tile0 .. tile0 + T - 1; starts, stops, offsets and the
outputs stay indexed by the local tile 0 .. T - 1.

Gradients: `CompositeTiles` is the custom VJP of the JAX package's
`composite_tiles` and `PackSorted` that of its pack gather
(`_gather_rows_t`): the per-instance gradient rows are reduced to
per-Gaussian rows deterministically, with no atomics. Each Gaussian's row
is the sum of the cotangent columns of its own instances, taken in the
expansion order (slot by slot of its segment [cum - counts, cum)) in
float64 and rounded to float32 once, in one fixed order of sums: the
kernel csrc/pack_vjp.cu (`kernels.pack_vjp`) for CUDA tensors and its
plain version `pack_vjp_plain`, bit-equal to it, for CPU tensors. Only the
read of `Binning.slot` spans the whole capacity; every cotangent moved and
summed is a live instance's.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..runtime.profiling import span
from . import compositing as comp
from .binning import Binning
from .projection import Projected
from .rasterize_tiled import blend_tiles, tile_offsets, tile_pixels

DATA_ROWS = 16
N_ACC = 8


def _pixels(grid_x: int, num_tiles: int, tile_x: int, tile_y: int, device,
            offsets=None, tile0: int = 0) -> torch.Tensor:
    """f32 [T, P, 2]: the pixel coordinates of tiles tile0 .. tile0 + T - 1
    of the grid, plus the subpixel offsets when given."""
    pixf = tile_pixels(grid_x, 0, tile_x, tile_y, device, tile0=tile0, num_tiles=num_tiles)
    return pixf if offsets is None else pixf + offsets


class PackSorted(torch.autograd.Function):
    """data[:, k] = rows[:, order[k]] (order clipped to [0, P)), with a
    deterministic VJP: Gaussian g's gradient row is the sum of the
    cotangent columns of its instances, which fill the expansion slots
    [cum - counts, cum) (Binning.slot maps each sorted instance to its
    slot). Tail slots (past the last instance) alias real Gaussians through
    the clipped order; they come after every segment and are summed into
    none. Autograd of index_select would scatter-add with float atomics on
    the GPU.

    The sums are segment sums over the live instances, in float64, rounded
    to float32 once (`pack_vjp_plain` has the order). The order depends
    only on each instance's place in its segment: within a Gaussian the
    expansion order is the sorted order (its instances lie in distinct
    tiles, expanded in tile order), except where the tight cull moved an
    instance past the last tile; there the culled instance keeps its slot,
    and since its cotangent is zero either way, every gradient is bit-equal
    with the cull on and off."""

    @staticmethod
    def forward(ctx, rows, order, cum, counts, slot):
        ctx.save_for_backward(cum, counts, slot)
        return rows.index_select(1, order.long().clamp(0, rows.shape[1] - 1))

    @staticmethod
    def backward(ctx, ct):
        with span("ex4dgs.backward.pack"):
            cum, counts, slot = ctx.saved_tensors
            ct = ct.contiguous()
            if ct.device.type == "cpu":
                d_rows = pack_vjp_plain(ct, slot, cum, counts)
            else:
                d_rows = kernels.pack_vjp(ct, slot, cum, counts)
        return d_rows, None, None, None, None


# pack_vjp_plain's lanes: each Gaussian's instances are dealt to this many
# running sums in turn (csrc/pack_vjp.cu's 32 lanes of a warp).
PACK_LANES = 32


def pack_vjp_plain(ct, slot, cum, counts):
    """The pack VJP's plain PyTorch version, bit-equal to the kernel
    (csrc/pack_vjp.cu, `kernels.pack_vjp`): d_rows [R, P] from the
    cotangent ct [R, capacity] (R = 16 on the kernel's path), slot i32
    [capacity] (Binning.slot) and cum, counts i32 [P].

    Gaussian g's instances are the expansion slots j in [lo, hi), lo =
    cum - counts and hi = cum clamped to [0, capacity], and instance j's
    cotangent is the sorted column slot_s[j], slot_s the inverse of slot.
    Its m-th instance (m = j - lo) goes to running sum m % 32, each a
    float64 sum from 0 in the order of m; the 32 sums are added pairwise at
    distances 16, 8, 4, 2, 1 (sum l + sum l + 16, and so on), and the
    result is rounded to float32 once. A Gaussian with no instance gets 0.
    Only the slots below the largest hi are read: every tensor but the
    inverse of slot is sized by the live instances."""
    dev = ct.device
    R, capacity = ct.shape
    P = cum.shape[0]
    out = torch.zeros((R, P), dtype=torch.float32, device=dev)
    if P == 0 or capacity == 0:
        return out
    slot_s = torch.empty(capacity, dtype=torch.int32, device=dev)
    slot_s[slot.long()] = torch.arange(capacity, dtype=torch.int32, device=dev)
    hi = cum.long().clamp(0, capacity)
    lo = (cum.long() - counts.long()).clamp(0, capacity)
    n = (hi - lo).clamp_min(0)
    live = int(hi.max())
    if live == 0:
        return out
    j = torch.arange(live, device=dev)
    g = torch.searchsorted(hi, j, right=True)  # the segment of slot j
    m = j - lo[g]
    lane_at = lo[g] + m % PACK_LANES  # where the running sum of j's lane lives
    rnd = m // PACK_LANES
    vals = ct.index_select(1, slot_s[:live].long()).double()  # [R, live]
    part = torch.zeros_like(vals)
    # the running sums, one round of 32 instances a Gaussian at a time
    by_round = torch.argsort(rnd, stable=True)
    for idx in torch.split(by_round, torch.bincount(rnd).tolist()):
        dst = lane_at[idx]
        part[:, dst] = part[:, dst] + vals[:, idx]
    # the pairwise sums over each Gaussian's first min(n, 32) slots; a lane
    # past n holds 0, and x + 0 is x
    width = torch.clamp_max(n[g], PACK_LANES)
    dist = PACK_LANES // 2
    while dist:
        dst = j[(m < dist) & (m + dist < width)]
        part[:, dst] = part[:, dst] + part[:, dst + dist]
        dist //= 2
    has = n > 0
    out[:, has] = part[:, lo[has]].float()
    return out


def pack_sorted(proj: Projected, colors, flow, binning: Binning):
    """(data f32 [16, capacity], gid i32 [capacity]): per-instance rows in
    sorted order, and each instance's Gaussian id. Differentiable in the
    projected quantities, colors and flow through PackSorted."""
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
    # feature-major [16, capacity], no transpose
    data = PackSorted.apply(rows, binning.order, binning.cum, binning.counts, binning.slot)
    return data, binning.order.to(torch.int32).contiguous()


def composite_tiles_fwd(data, gid, starts, stops, *, grid_x: int, tile_x: int = 32,
                        tile_y: int = 16, track_idx: bool = True, offsets=None,
                        tile0: int = 0):
    """Composite every tile's instance range [starts[t], stops[t]) of the
    packed buffer, each pixel moved by its subpixel offset when `offsets`
    (f32 [T, P, 2]) is given. Returns accum f32 [T, P, 8], tfinal f32
    [T, P, 1] and bestidx i32 [T, P, 1] (all -1 unless track_idx),
    P = tile_x * tile_y. Tile t is the grid's tile tile0 + t.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if data.device.type == "cpu":
        return composite_tiles_plain(data, gid, starts, stops, grid_x=grid_x,
                                     tile_x=tile_x, tile_y=tile_y, track_idx=track_idx,
                                     offsets=offsets, tile0=tile0)
    return kernels.composite_fwd(data, gid, starts, stops, grid_x=grid_x, tile_x=tile_x,
                                 tile_y=tile_y, track_idx=track_idx, offsets=offsets,
                                 tile0=tile0)


def composite_tiles_plain(data, gid, starts, stops, *, grid_x: int, tile_x: int = 32,
                          tile_y: int = 16, track_idx: bool = True, offsets=None,
                          tile0: int = 0, chunk: int = 64, tile_batch: int = 1024):
    """The kernel's plain PyTorch version, same signature and outputs: the
    oracle's chunked blend (ops/rasterize_tiled.py) over the packed rows,
    `tile_batch` tiles at a time to bound the [tiles, pixels, chunk]
    intermediates."""
    dev = data.device
    T = starts.shape[0]
    npix = tile_x * tile_y
    rows = data[:14].t()  # [capacity, 14]
    xy, conic, opac, feats = rows[:, 0:2], rows[:, 2:5], rows[:, 5], rows[:, 6:14]
    pixf = _pixels(grid_x, T, tile_x, tile_y, dev, offsets, tile0)  # [T, P, 2]

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


def warp_boxes(grid_x: int, num_tiles: int, tile_x: int, tile_y: int,
               device, offsets=None, tile0: int = 0) -> torch.Tensor:
    """f32 [T, P // 32, 4]: the (x0, x1, y0, y1) bounding box of each warp's
    32 pixels (pixels 32w .. 32w + 31 of the tile, p = y * tile_x + x), for
    the grid's tiles tile0 .. tile0 + T - 1.

    Without offsets it is formed as csrc/composite_common.cuh::warp_box forms
    it: pixel centres, and a warp that spans rows covers every column of the
    tile. With offsets (f32 [T, P, 2]) as warp_box_of forms it: the least
    and largest rounded coordinate centre + offset over the warp's pixels
    whose two coordinates are finite (a pixel with a non-finite one passes
    no instance's test); a warp with no such pixel gets the inverted box
    (inf, -inf, inf, -inf), which skips no instance that passes the
    opacity floor."""
    if offsets is not None:
        pix = _pixels(grid_x, num_tiles, tile_x, tile_y, device, offsets, tile0)
        pix = pix.reshape(num_tiles, -1, 32, 2)
        ok = torch.isfinite(pix).all(-1, keepdim=True)
        inf = torch.full((), float("inf"), device=device)
        lo = torch.where(ok, pix, inf).amin(2)
        hi = torch.where(ok, pix, -inf).amax(2)
        return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], dim=-1)
    first = torch.arange(0, tile_x * tile_y, 32, device=device)
    r0, r1 = first // tile_x, (first + 31) // tile_x
    wraps = r1 != r0
    c0 = torch.where(wraps, 0, first - r0 * tile_x)
    c1 = torch.where(wraps, tile_x - 1, first + 31 - r1 * tile_x)
    t = tile0 + torch.arange(num_tiles, device=device)[:, None]
    tx0, ty0 = (t % grid_x) * tile_x, (t // grid_x) * tile_y
    return torch.stack([tx0 + c0, tx0 + c1, ty0 + r0, ty0 + r1], dim=-1).float()


def warp_cull_plain(xy, conic, opacity, box):
    """The per-warp cull of csrc/composite_common.cuh::warp_skips in
    PyTorch, operation for operation: True where no pixel of the warp's box
    can pass the kernel's exact per-pixel test, so that the warp skips the
    instance. xy [..., 2], conic [..., 3], opacity [...] and box [..., 4]
    (warp_boxes) broadcast against each other; all float32. The tests and
    chip_smoke.py's pair counts use it; no path of the port runs it."""
    x, y = xy[..., 0], xy[..., 1]
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    x0, x1, y0, y1 = box.unbind(-1)
    lx, hx = x - x1, x - x0
    ly, hy = y - y1, y - y0

    def edge_min(p, q, s, lo, hi):  # min over t in [lo, hi] of p t^2 + 2 b t s + q s^2
        t = torch.fmin(torch.fmax(-(b * s) / p, lo), hi)
        return p * t * t + 2.0 * b * t * s + q * s * s

    inside = (lx <= 0.0) & (hx >= 0.0) & (ly <= 0.0) & (hy >= 0.0)
    edges = torch.fmin(torch.fmin(edge_min(a, c, ly, lx, hx), edge_min(a, c, hy, lx, hx)),
                       torch.fmin(edge_min(c, a, lx, ly, hy), edge_min(c, a, hx, ly, hy)))
    qmin = torch.where(inside, torch.zeros_like(edges), edges)
    bx = torch.fmax(lx.abs(), hx.abs())
    by = torch.fmax(ly.abs(), hy.abs())
    m = a * bx * bx + c * by * by + 2.0 * b.abs() * bx * by
    lim = 2.0 * torch.log(255.0 * opacity) + 1e-4 + 1e-5 * m
    finite = (torch.isfinite(xy).all(-1) & torch.isfinite(conic).all(-1)
              & torch.isfinite(opacity))
    definite = (a > 0.0) & (a * c - b * b > 0.0)
    return ~(opacity >= comp.ALPHA_MIN) | (finite & definite & (qmin > lim))


# The forward kernel's tfinal against its plain version, relative to the
# plain value: the two multiply the same factors in another association (the
# plain version's chunked cumprod), a few ulp apart (2.1e-6 on the bench
# frame). A contributing pair that the cull dropped would change tfinal by a
# factor of at most 1 - 1/255, 3.9e-3 relative, so TF_RTOL sits well below
# that and far above the rounding. Pixels on the latch are left out: where the
# last product lands within rounding of T_EPS, one version applies the sample
# and the other latches before it, and their tfinal differ by that sample's
# 1 - alpha (3.6e-2 on the bench frame, for the kernel without the cull as
# with it); the version that applied it then holds a tfinal within TF_RTOL of
# T_EPS.
TF_RTOL = 1e-3


def tfinal_rel_err(tf_k, tf_p) -> tuple[float, int]:
    """(largest |tf_k - tf_p| / tf_p over the pixels off the latch, the
    number of pixels on it): to be held to TF_RTOL."""
    on_latch = torch.minimum(tf_k, tf_p) < comp.T_EPS * (1 + TF_RTOL)
    rel = torch.where(on_latch, 0.0, (tf_k - tf_p).abs() / tf_p)
    return rel.max().item(), int(on_latch.sum().item())


# The backward kernel sums each instance's pixels in another order than its
# plain version: an element may differ by BWD_RTOL of itself plus BWD_ATOL of
# its row group's largest magnitude.
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6
# Where float32 evaluations of the closed form do not meet BWD_RTOL/BWD_ATOL
# against each other (near-singular conics, long running sums that cancel),
# the port's error may reach this multiple of a reference evaluation's: on
# the hard frames, of JAX's float32 error against float64
# (tests/test_torch_backward.py); on a frame of the trainer's, of the plain
# version's spread against itself (chip_smoke.py).
HARD_FRAME_RATIO = 2.0
BWD_ROWS = {"xy": slice(0, 2), "conic": slice(2, 5), "opacity": slice(5, 6),
            "features": slice(6, 14)}


def bwd_errors(got, want, lo: int, hi: int) -> dict[str, tuple[float, float, float]]:
    """Per row group of BWD_ROWS over the columns [lo, hi): (largest
    |got - want|, largest |got - want| / (BWD_RTOL |want| + floor), floor =
    BWD_ATOL max |want| of the group). The middle value is to be held to 1."""
    out = {}
    for name, rows in BWD_ROWS.items():
        ref = want[rows, lo:hi]
        diff = (got[rows, lo:hi] - ref).abs()
        floor = BWD_ATOL * ref.abs().max().item()
        limit = (BWD_RTOL * ref.abs() + floor).clamp_min(1e-30)
        out[name] = (diff.max().item(), (diff / limit).max().item(), floor)
    return out


def composite_tiles_bwd(data, starts, stops, gacc, acdot, gend, tfinal, *, grid_x: int,
                        tile_x: int = 32, tile_y: int = 16, offsets=None, tile0: int = 0):
    """Per-instance gradient rows dgrad f32 [16, capacity] of the forward
    composite, from the cotangents gacc f32 [T, P, 8] (of accum, with the
    color cotangent folded in), acdot = accum[..., :3] . gacc[..., :3],
    gend = the cotangent of tfinal (color's included), and the forward's
    tfinal, all [T, P, 1], the forward's subpixel offsets, if any, and its
    first tile tile0. Rows:
    0-1 dxy, 2-4 dconic, 5 dopacity, 6-13 dfeat, 14-15 zero; columns outside
    every tile's range are zero.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if data.device.type == "cpu":
        return composite_tiles_bwd_plain(data, starts, stops, gacc, acdot, gend, tfinal,
                                         grid_x=grid_x, tile_x=tile_x, tile_y=tile_y,
                                         offsets=offsets, tile0=tile0)
    return kernels.composite_bwd(data, starts, stops, gacc, acdot, gend, tfinal,
                                 grid_x=grid_x, tile_x=tile_x, tile_y=tile_y, offsets=offsets,
                                 tile0=tile0)


def composite_tiles_bwd_plain(data, starts, stops, gacc, acdot, gend, tfinal, *,
                              grid_x: int, tile_x: int = 32, tile_y: int = 16,
                              offsets=None, tile0: int = 0, chunk: int = 64,
                              tile_batch: int = 256):
    """The backward kernel's plain PyTorch version, same signature and
    outputs: the closed form of the blend's gradient, walked `tile_batch`
    tiles and `chunk` instances at a time like composite_tiles_plain. Per
    pixel and applied instance i (applied: before the pixel's latch):

      dL/dalpha_i = T_i (c_i . gc) - (S_i + tfinal gend) / max(1 - alpha_i, 0.01)
      S_i         = acdot - sum_{j <= i} w_j (c_j . gc)
      dL/dpower_i = opacity_i e^power_i dL/dalpha_i   (straight-through clamp)
      dL/dopac_i  = e^power_i dL/dalpha_i
      dfeat_i     = w_i gacc

    and every row is summed over the tile's pixels. No autograd graph."""
    dev = data.device
    T = starts.shape[0]
    capacity = data.shape[1]
    rows = data[:14].t()  # [capacity, 14]
    pixf = _pixels(grid_x, T, tile_x, tile_y, dev, offsets, tile0)  # [T, P, 2]
    lanes = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
    dgrad = torch.zeros((DATA_ROWS, capacity), dtype=torch.float32, device=dev)
    for b in range(0, T, tile_batch):
        s = slice(b, b + tile_batch)
        st, sp = starts[s], stops[s]
        longest = int((sp - st).max().item()) if st.numel() else 0
        gac = gacc[s]  # [B, P, 8]
        gc = gac[..., None, 0:3]  # [B, P, 1, 3]
        acd = acdot[s]  # [B, P, 1]
        tf_term = tfinal[s] * gend[s]  # [B, P, 1]
        pix = pixf[s][:, :, None, :]  # [B, P, 1, 2]
        cum_in = torch.ones(acd.shape, dtype=torch.float32, device=dev)
        pref = torch.zeros_like(cum_in)
        for j in range(-(-longest // chunk)):
            idx = st[:, None] + j * chunk + lanes  # [B, C]
            ok = idx < sp[:, None]
            ic = idx.clamp(0, capacity - 1).long()
            r = rows[ic][:, None]  # [B, 1, C, 14]
            dx = r[..., 0] - pix[..., 0]  # [B, P, C]
            dy = r[..., 1] - pix[..., 1]
            ca, cb, cc, op = r[..., 2], r[..., 3], r[..., 4], r[..., 5]
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            e = torch.exp(torch.clamp_max(power, 0.0))
            alpha_c = torch.clamp_max(op * e, comp.ALPHA_MAX)
            m = ok[:, None] & (power <= 0.0) & (alpha_c >= comp.ALPHA_MIN)
            zero = torch.zeros((), device=dev)
            alpha = torch.where(m, alpha_c, zero)
            cum = cum_in * torch.cumprod(1.0 - alpha, dim=-1)
            cum_excl = torch.cat([cum_in, cum[..., :-1]], dim=-1)
            applied = m & (cum >= comp.T_EPS)
            w = torch.where(applied, alpha * cum_excl, zero)
            # Lanes past the range read a neighbour's rows; zero them so a
            # non-finite row there cannot reach a sum through a zero weight.
            feats = torch.where(ok[:, None, :, None], r[..., 6:14], zero)
            cdot = (feats[..., 0:3] * gc).sum(-1)  # [B, P, C]
            incl = torch.cumsum(w * cdot, dim=-1) + pref
            dl_dalpha = torch.where(
                applied,
                cum_excl * cdot - (acd - incl + tf_term) / torch.clamp_min(1.0 - alpha, 0.01),
                zero)
            e_term = e * dl_dalpha
            dlp = op * e_term
            g = torch.stack([
                (-(ca * dx + cb * dy) * dlp).sum(1),
                (-(cc * dy + cb * dx) * dlp).sum(1),
                (-0.5 * dx * dx * dlp).sum(1),
                (-dx * dy * dlp).sum(1),
                (-0.5 * dy * dy * dlp).sum(1),
                e_term.sum(1),
            ], dim=-1)  # [B, C, 6]
            dfeat = torch.einsum("bpc,bpf->bcf", w, gac)  # [B, C, 8]
            vals = torch.cat([g, dfeat], dim=-1)[ok]  # [n_ok, 14]
            dgrad[:14, idx[ok].long()] = vals.t()
            cum_in = cum[..., -1:]
            pref = incl[..., -1:]
    return dgrad


def composite_tiles_bwd_walk(data, starts, stops, gacc, acdot, gend, tfinal, *,
                             grid_x: int, tile_x: int = 32, tile_y: int = 16,
                             offsets=None, tile0: int = 0, tile_batch: int = 256):
    """The backward kernel's twin, same signature and outputs: the plain
    version's arithmetic walked one instance at a time (each pixel's
    transmittance and running sum of w c . gc updated per instance, as the
    kernel does), and each instance's rows summed over the pixels in the
    kernel's order: within each warp of 32 pixels the pairwise tree over
    lane bits 16, 8, 4, 2, 1, then the warps' sums added to 0.0 in warp
    order. Every operation is a correctly rounded float32 operation in the
    kernel's order, so on the card (the same expf) the kernel's dgrad equals
    it bit for bit. The tests use it; no path of the port runs it."""
    dev = data.device
    T = starts.shape[0]
    capacity = data.shape[1]
    npix = tile_x * tile_y
    rows = data[:14].t()  # [capacity, 14]
    pixf = _pixels(grid_x, T, tile_x, tile_y, dev, offsets, tile0)  # [T, P, 2]
    dgrad = torch.zeros((DATA_ROWS, capacity), dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    for b in range(0, T, tile_batch):
        s = slice(b, b + tile_batch)
        st, sp = starts[s], stops[s]
        longest = int((sp - st).max().item()) if st.numel() else 0
        g = gacc[s].unbind(-1)  # 8 x [B, P]
        acd = acdot[s][..., 0]
        tf_term = tfinal[s][..., 0] * gend[s][..., 0]
        px, py = pixf[s].unbind(-1)
        t_run = torch.ones_like(acd)
        incl = torch.zeros_like(acd)
        done = torch.zeros(acd.shape, dtype=torch.bool, device=dev)
        for j in range(longest):
            idx = st + j
            ok = idx < sp
            r = rows[idx.clamp(0, capacity - 1).long()][:, None, :]  # [B, 1, 14]
            x, y, ca, cb, cc, op, cr, cg, cbl = r[..., 0:9].unbind(-1)
            dx, dy = x - px, y - py
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            e = torch.exp(torch.clamp_max(power, 0.0))
            alpha = torch.clamp_max(op * e, comp.ALPHA_MAX)
            m = ok[:, None] & ~done & (power <= 0.0) & (alpha >= comp.ALPHA_MIN)
            one_m = 1.0 - alpha
            t_next = t_run * one_m
            latch = m & (t_next < comp.T_EPS)
            applied = m & ~latch
            done = done | latch
            w = alpha * t_run
            cdot = (cr * g[0] + cg * g[1]) + cbl * g[2]
            incl_next = w * cdot + incl
            dl_dalpha = t_run * cdot - ((acd - incl_next) + tf_term) / torch.clamp_min(one_m, 0.01)
            e_term = e * dl_dalpha
            dlp = op * e_term
            terms = torch.stack([
                -(ca * dx + cb * dy) * dlp, -(cc * dy + cb * dx) * dlp,
                -0.5 * dx * dx * dlp, -dx * dy * dlp, -0.5 * dy * dy * dlp, e_term,
                *(w * gf for gf in g)], dim=-1)  # [B, P, 14]
            terms = torch.where(applied[..., None], terms, zero)
            t_run = torch.where(applied, t_next, t_run)
            incl = torch.where(applied, incl_next, incl)
            v = terms.reshape(terms.shape[0], npix // 32, 32, 14)
            for half in (16, 8, 4, 2, 1):
                v = v[:, :, :half] + v[:, :, half:2 * half]
            total = torch.zeros((terms.shape[0], 14), device=dev)
            for wp in v[:, :, 0].unbind(1):
                total = total + wp
            dgrad[:14, idx[ok].long()] = total[ok].t()
    return dgrad


class CompositeTiles(torch.autograd.Function):
    """The compositing step with its closed-form gradient: the counterpart
    of the JAX package's `composite_tiles` custom VJP.

    Forward: (color [T, P, 3], accum [T, P, 8], tfinal [T, P, 1],
    bestidx [T, P, 1]) from composite_tiles_fwd, color = accum[..., :3] +
    tfinal * bg. Backward: the color cotangent folds into the accum and
    tfinal cotangents and composite_tiles_bwd gives the per-instance rows,
    zero outside [starts[0], stops[-1]) (the tail slots alias real Gaussians
    through the clipped order, so they must carry nothing). The subpixel
    offsets (None, or f32 [T, P, 2]) get no gradient; tile0 is the grid
    index of tile 0 (a slab's first tile, else 0)."""

    @staticmethod
    def forward(ctx, data, bg, gid, starts, stops, offsets, grid_x, tile_x, tile_y,
                track_idx, tile0=0):
        accum, tfinal, bestidx = composite_tiles_fwd(
            data, gid, starts, stops, grid_x=grid_x, tile_x=tile_x, tile_y=tile_y,
            track_idx=track_idx, offsets=offsets, tile0=tile0)
        color = accum[..., 0:3] + tfinal * bg
        ctx.save_for_backward(data, bg, accum, tfinal, starts, stops, offsets)
        ctx.grid = (grid_x, tile_x, tile_y, tile0)
        ctx.mark_non_differentiable(bestidx)
        return color, accum, tfinal, bestidx

    @staticmethod
    def backward(ctx, g_color, g_accum, g_tfinal, _g_bestidx):
        with span("ex4dgs.backward.composite"):
            data, bg, accum, tfinal, starts, stops, offsets = ctx.saved_tensors
            grid_x, tile_x, tile_y, tile0 = ctx.grid
            gacc = g_accum.clone()
            gacc[..., 0:3] += g_color
            gend = (g_color * bg).sum(-1, keepdim=True) + g_tfinal
            acdot = (accum[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
            dgrad = composite_tiles_bwd(data, starts, stops, gacc.contiguous(),
                                        acdot.contiguous(), gend.contiguous(), tfinal,
                                        grid_x=grid_x, tile_x=tile_x, tile_y=tile_y,
                                        offsets=offsets, tile0=tile0)
            g_bg = (g_color * tfinal).sum((0, 1)) if ctx.needs_input_grad[1] else None
        return dgrad, g_bg, None, None, None, None, None, None, None, None, None


def composite_blocks(proj: Projected, colors, flow, binning: Binning, *, grid_x: int, bg,
                     max_depth: float, tile_x: int = 32, tile_y: int = 16,
                     track_idx: bool = True, offsets=None, tile0: int = 0) -> comp.RenderOutputs:
    """Pack and composite the binning's tiles, the grid's tiles tile0 ..
    tile0 + T - 1 (T = the binning's tile count), into per-tile pixel
    blocks [T, P, ...]: color, the acc-normalised depth and flow, acc,
    final_t and idx (all -1 unless track_idx). Differentiable through
    CompositeTiles and PackSorted; offsets (f32 [T, P, 2]) get no
    gradient."""
    data, gid = pack_sorted(proj, colors, flow, binning)
    color, accum, tfinal, bestidx = CompositeTiles.apply(
        data, bg, gid, binning.tile_start, binning.tile_stop, offsets, grid_x, tile_x,
        tile_y, track_idx, tile0)
    acc = accum[..., 7].detach()
    has = acc > 0.0
    denom = torch.where(has, acc, torch.ones_like(acc))
    depth = torch.where(has, accum[..., 3] / denom, torch.full_like(acc, max_depth))
    flow_b = torch.where(has[..., None], accum[..., 4:7] / denom[..., None],
                         torch.zeros_like(accum[..., 4:7]))
    return comp.RenderOutputs(color=color, depth=depth, flow=flow_b, acc=acc,
                              final_t=tfinal[..., 0], idx=bestidx[..., 0])


def rasterize_tiled_cuda(proj: Projected, colors, flow, binning: Binning, *, width: int,
                         height: int, bg, max_depth: float, tile_x: int = 32,
                         tile_y: int = 16, track_idx: bool = True,
                         subpixel_offset=None) -> comp.RenderOutputs:
    """Drop-in for ops.rasterize_tiled.rasterize_tiled that composites with
    the kernels (plain versions on the CPU), differentiable through
    CompositeTiles and PackSorted. track_idx=False skips the
    dominant-contributor bookkeeping; `idx` then comes back all -1.
    subpixel_offset: optional f32 [H, W, 2] on the render's device; pixel
    (x, y) is evaluated at (x + off[y, x, 0], y + off[y, x, 1]), and the
    offsets get no gradient."""
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    offsets = None
    if subpixel_offset is not None:
        offsets = tile_offsets(subpixel_offset.detach(), grid_x, grid_y, tile_x, tile_y)
    blocks = composite_blocks(proj, colors, flow, binning, grid_x=grid_x, bg=bg,
                              max_depth=max_depth, tile_x=tile_x, tile_y=tile_y,
                              track_idx=track_idx, offsets=offsets)
    return comp.RenderOutputs(*(comp.tiles_to_image(a, grid_y, grid_x, tile_y, tile_x, height,
                                                    width) for a in blocks))
