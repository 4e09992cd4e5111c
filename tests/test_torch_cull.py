"""The per-warp cull of kernel A (csrc/composite_common.cuh::warp_skips)
through its plain twin `ops.rasterize_cuda.warp_cull_plain`.

The cull must be conservative for the kernel's exact per-pixel test as it is
computed in fp32: on seeded sweeps, no (tile, warp, instance) that the twin
skips has a pixel of the warp at which `chunk_alpha`'s mask is true. The
sweeps put opacities at and around 1/255, splats just outside a warp with
the opacity that puts its nearest pixel on the alpha floor, conics near
singular and very anisotropic, means on tile and warp edges and far away,
and NaN and inf inputs, at 32x16, 16x16, 8x4 and 24x4 tiles (24x4: a warp
wraps across rows). On a projected scene the twin skips a nonzero share.

The near-threshold and near-singular sweeps are also packed as frames. On
the CPU, dropping one contributing pair of such a frame breaks the relative
tfinal check (`tfinal_rel_err`); on the card (`cuda`), the frames go through
the kernel itself, so its own predicate is held to the same inputs.

A library is named by the digest of its source and of every header beside
it, so an edited header rebuilds the sources that may include it.
"""
import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.ops import compositing as comp
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
from ex4dgs_tpu_torch.ops.rasterize_tiled import tile_pixels

torch.set_num_threads(2)

TILES = [(32, 16), (16, 16), (8, 4), (24, 4)]
GRID = (3, 2)  # tiles across, down
N = 1500  # instances per sweep
ONE_255 = np.float32(1.0 / 255.0)


def _grid(tile, offsets=None):
    """(pixel coordinates [T, P, 2], warp boxes [T, W, 4], width, height) of
    the sweep's grid, the pixels moved by per-tile subpixel offsets
    [T, P, 2] when given."""
    gx, gy = GRID
    tx, ty = tile
    pixf = tile_pixels(gx, gy, tx, ty, "cpu")  # [T, P, 2]
    boxes = trc.warp_boxes(gx, gx * gy, tx, ty, "cpu", offsets=offsets)  # [T, W, 4]
    if offsets is not None:
        pixf = pixf + offsets
    return pixf, boxes, gx * tx, gy * ty


def grid_offsets(tile, scale, seed=0):
    """Seeded per-tile subpixel offsets f32 [T, P, 2] of the sweep's grid,
    U(-scale, scale); scale "nonfinite" draws U(-0.5, 0.5) and then puts
    NaN, inf or -inf into a coordinate of some pixels and NaN into every
    pixel of one warp (tile 1's warp 0)."""
    gx, gy = GRID
    rng = np.random.default_rng(seed)
    shape = (gx * gy, tile[0] * tile[1], 2)
    if scale != "nonfinite":
        return torch.from_numpy(rng.uniform(-scale, scale, shape).astype(np.float32))
    off = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    flat = off.reshape(-1, 2)
    bad = rng.choice(flat.shape[0], flat.shape[0] // 20, replace=False)
    flat[bad, rng.integers(0, 2, len(bad))] = rng.choice([np.nan, np.inf, -np.inf], len(bad))
    off[1, 0:32] = np.nan
    return torch.from_numpy(off)


def _conics(rng, n, anisotropy=(0.0, 2.0), size=(0.3, 30.0)):
    """Inverse 2D covariances of splats with random rotation, a random
    size in pixels and an axis ratio of 10^U(anisotropy)."""
    s = np.exp(rng.uniform(np.log(size[0]), np.log(size[1]), n))
    r = 10.0 ** rng.uniform(*anisotropy, n)
    th = rng.uniform(0, np.pi, n)
    c, s_ = np.cos(th), np.sin(th)
    l1, l2 = 1.0 / s**2, 1.0 / (s * r) ** 2
    a = c * c * l1 + s_ * s_ * l2
    b = c * s_ * (l1 - l2)
    cc = s_ * s_ * l1 + c * c * l2
    return np.stack([a, b, cc], -1)


def _q(conic, d):
    return conic[..., 0] * d[..., 0] ** 2 + 2 * conic[..., 1] * d[..., 0] * d[..., 1] \
        + conic[..., 2] * d[..., 1] ** 2


def _on_the_floor(rng, conic, xy, pixf):
    """Opacities that put each splat's best pixel of the grid within a few
    1e-7 of the alpha floor (above and below)."""
    d = xy[:, None, :] - pixf.reshape(-1, 2).numpy()[None].astype(np.float64)
    qpix = _q(conic[:, None, :], d).min(1)
    eps = rng.choice([-1e-6, -3e-7, -1e-7, 0.0, 1e-7, 3e-7, 1e-6], len(xy))
    return np.exp(np.minimum(0.5 * qpix, 80.0)) / 255.0 * (1.0 + eps)


def _sweep(kind, tile, seed=0, offsets=None):
    """(xy [N, 2], conic [N, 3], opacity [N]) float32 arrays of one sweep,
    on the grid's pixels moved by `offsets` when given (their non-finite
    entries read as 0 here)."""
    rng = np.random.default_rng(seed)
    if offsets is not None:
        offsets = torch.nan_to_num(offsets, nan=0.0, posinf=0.0, neginf=0.0)
    pixf, boxes, w, h = _grid(tile, offsets)
    n = N
    if kind == "random":
        xy = rng.uniform([-40, -40], [w + 40, h + 40], (n, 2))
        conic = _conics(rng, n)
        op = rng.uniform(0, 1, n)
    elif kind == "threshold":
        # Means on a warp box's edge row or column, a few pixels outside,
        # half of them with axis-aligned conics: the best pixel is then the
        # box's own nearest point.
        b = boxes.reshape(-1, 4).numpy()[rng.integers(0, boxes.shape[0] * boxes.shape[1], n)]
        side = rng.integers(0, 4, n)
        k = rng.integers(1, 12, n) + rng.choice([0.0, 0.5, 0.25], n)
        row = rng.uniform(b[:, 2], b[:, 3] + 1e-9).round()
        col = rng.uniform(b[:, 0], b[:, 1] + 1e-9).round()
        xy = np.stack([np.select([side == 0, side == 1], [b[:, 0] - k, b[:, 1] + k], col),
                       np.select([side == 2, side == 3], [b[:, 2] - k, b[:, 3] + k], row)], -1)
        conic = _conics(rng, n, size=(1.0, 20.0))
        conic[: n // 2, 1] = 0.0
        xy, conic = xy.astype(np.float32).astype(np.float64), conic.astype(np.float32)
        op = _on_the_floor(rng, conic.astype(np.float64), xy, pixf)
        # and opacities at 1/255 and its neighbours, means on pixel centres
        m = n // 5
        xy[:m] = pixf.reshape(-1, 2).numpy()[rng.integers(0, pixf.shape[0] * pixf.shape[1], m)]
        op[:m] = np.nextafter(ONE_255, rng.choice([-1.0, 2.0], m)).astype(np.float64)
        op[: m // 2] = ONE_255
    elif kind == "singular":
        xy = rng.uniform([-20, -20], [w + 20, h + 20], (n, 2))
        conic = _conics(rng, n, anisotropy=(2.0, 6.0), size=(0.05, 5.0))
        # and conics with b^2 -> ac from either side of the singular line
        m = n // 2
        a, c = np.exp(rng.uniform(-6, 1, (2, m)))
        b = np.sqrt(a * c) * rng.choice([-1, 1], m) * (1 - 10.0 ** -rng.uniform(1, 9, m))
        conic[:m] = np.stack([a, b, c], -1)
        op = rng.uniform(ONE_255, 1, n)
        op[m:] = _on_the_floor(rng, conic[m:].astype(np.float32).astype(np.float64),
                               xy[m:].astype(np.float32).astype(np.float64), pixf)
    elif kind == "edges":
        # Means on tile and warp edges (integer and half-integer pixel
        # coordinates), and far outside the grid.
        xs = np.concatenate([np.arange(0, w + 1, 8), np.arange(0, w + 1, 8) - 0.5])
        ys = np.concatenate([np.arange(0, h + 1, 2), np.arange(0, h + 1, 2) - 0.5])
        xy = np.stack([rng.choice(xs, n), rng.choice(ys, n)], -1)
        far = rng.integers(0, n, n // 4)
        xy[far] = rng.choice([-1e7, -1e4, 1e4, 1e7], (len(far), 2))
        conic = _conics(rng, n, size=(0.3, 2e3))
        op = rng.uniform(0, 1, n)
    elif kind == "nonfinite":
        xy = rng.uniform([-20, -20], [w + 20, h + 20], (n, 2))
        conic = _conics(rng, n)
        op = rng.uniform(ONE_255, 1, n)
        bad = [np.nan, np.inf, -np.inf, 0.0, -1.0, 3e38]
        for arr in (xy, conic):
            idx = rng.integers(0, n, n // 6)
            arr[idx, rng.integers(0, arr.shape[1], len(idx))] = rng.choice(bad, len(idx))
        op[rng.integers(0, n, n // 10)] = rng.choice(bad, n // 10)
    else:
        raise ValueError(kind)
    return (xy.astype(np.float32), conic.astype(np.float32),
            np.asarray(op).astype(np.float32))


def _skips_and_contributions(xy, conic, op, tile, offsets=None):
    """(skip, contributes), both bool [T, W, N]: the twin's cull, and
    whether some pixel of the warp passes chunk_alpha's exact test."""
    pixf, boxes, _, _ = _grid(tile, offsets)
    xy_t, conic_t, op_t = (torch.from_numpy(a) for a in (xy, conic, op))
    skip = trc.warp_cull_plain(xy_t, conic_t, op_t, boxes[:, :, None, :])
    ok = torch.ones((1, 1, len(op)), dtype=torch.bool)
    _, m = comp.chunk_alpha(pixf, xy_t[None, None], conic_t[None, None], op_t[None, None], ok)
    T, W = boxes.shape[:2]
    return skip, m.reshape(T, W, 32, -1).any(2)


@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
@pytest.mark.parametrize("kind", ["random", "threshold", "singular", "edges", "nonfinite"])
def test_warp_cull_is_conservative(kind, tile):
    xy, conic, op = _sweep(kind, tile)
    skip, contributes = _skips_and_contributions(xy, conic, op, tile)
    dropped = skip & contributes
    assert not bool(dropped.any()), f"{int(dropped.sum())} contributing pairs skipped"
    # The sweep means something: some pairs contribute and some are skipped.
    assert bool(contributes.any()) and bool(skip.any())
    if kind in ("threshold", "singular"):
        # the near-threshold splats are kept where they (just) contribute
        # and skipped where a neighbouring warp holds their best pixel
        assert bool((~skip & ~contributes).any())


def _sweep_frame(kind, tile, device="cpu", offsets=None):
    """The sweep packed as a frame for the forward kernel: (data [16, N],
    gid, starts, stops, grid_x), every tile's range holding all N
    instances. They are ordered by their largest alpha on the grid
    (float64; with `offsets`, on the moved pixels), smallest first, so that
    the near-floor pairs come before any pixel latches; colours, depth and
    flow come from a seed."""
    xy, conic, op = _sweep(kind, tile, offsets=offsets)
    if offsets is not None:
        offsets = torch.nan_to_num(offsets, nan=0.0, posinf=0.0, neginf=0.0)
    pixf, boxes, _, _ = _grid(tile, offsets)
    d = xy[:, None, :].astype(np.float64) - pixf.reshape(-1, 2).numpy()[None]
    best = op * np.exp(-0.5 * _q(conic.astype(np.float64)[:, None, :], d).min(1))
    order = np.argsort(best, kind="stable")
    n = len(op)
    rng = np.random.default_rng(1)
    data = np.zeros((16, n), np.float32)
    data[0:2], data[2:5], data[5] = xy[order].T, conic[order].T, op[order]
    data[6:9] = rng.uniform(0, 1, (3, n))
    data[9] = np.sort(rng.uniform(1, 10, n))
    data[10:13] = rng.normal(size=(3, n))
    data[13] = 1.0
    T = boxes.shape[0]
    starts, stops = np.zeros(T, np.int32), np.full(T, n, np.int32)
    return (torch.from_numpy(data).to(device), torch.arange(n, dtype=torch.int32, device=device),
            torch.from_numpy(starts).to(device), torch.from_numpy(stops).to(device), GRID[0])


FRAME_KINDS = ["threshold", "singular"]


@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_sweep_frame_check_sees_a_dropped_pair(kind, tile):
    """On the CPU: the sweep's frame keeps most pixels off the latch, and
    dropping one contributing near-floor pair (its opacity set to 0) moves
    tfinal past TF_RTOL at the pixels where it contributes, so the card's
    relative check on this frame sees any pair the cull drops."""
    data, gid, starts, stops, gx = _sweep_frame(kind, tile)
    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1])
    _, tfinal, _ = trc.composite_tiles_plain(data, gid, starts, stops, **kw)
    assert bool(torch.isfinite(tfinal).all())
    assert (tfinal >= comp.T_EPS * (1 + trc.TF_RTOL)).float().mean() > 0.5
    pixf = _grid(tile)[0]
    ok = torch.ones((1, 1, data.shape[1]), dtype=torch.bool)
    rows = data[:6].t()[None, None]
    alpha, m = comp.chunk_alpha(pixf, rows[..., 0:2], rows[..., 2:5], rows[..., 5], ok)
    near_floor = m & (alpha < comp.ALPHA_MIN * (1 + 1e-5))
    first = int(near_floor.flatten(0, 1).any(0).nonzero()[0])  # the earliest such pair
    dropped = data.clone()
    dropped[5, first] = 0.0
    _, tf_dropped, _ = trc.composite_tiles_plain(dropped, gid, starts, stops, **kw)
    rel, _ = trc.tfinal_rel_err(tfinal, tf_dropped)
    assert rel > trc.TF_RTOL, rel


def test_tfinal_rel_err_leaves_out_the_latch():
    plain = torch.tensor([0.5, 1e-4, 2e-4, 1.0])
    kernel = plain * torch.tensor([1 + 5e-4, 0.5, 1.0, 1.0])  # the second on the latch
    rel, on_latch = trc.tfinal_rel_err(kernel, plain)
    assert on_latch == 1 and abs(rel - 5e-4) < 1e-6


def _hold_kernel_a_on_sweep(kind, tile, offsets=None):
    """The sweep's frame (its pixels moved by `offsets`, if given) through
    csrc/composite_fwd.cu on the card against composite_tiles_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    data, gid, starts, stops, gx = _sweep_frame(kind, tile, "cuda", offsets=offsets)
    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1],
              offsets=None if offsets is None else offsets.cuda())
    before = kernels.launches["composite_fwd"]
    got = trc.composite_tiles_fwd(data, gid, starts, stops, **kw)
    want = trc.composite_tiles_plain(data, gid, starts, stops, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["composite_fwd"] == before + 1
    for a, w in zip(got[:2], want[:2]):
        assert bool(torch.isfinite(a).all()) and (a - w).abs().max().item() <= 2e-5
    rel, _ = trc.tfinal_rel_err(got[1], want[1])
    assert rel <= trc.TF_RTOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_kernel_keeps_the_sweeps_pairs_on_card(kind, tile):
    """The kernel's own predicate (composite_common.cuh::warp_skips) on the
    sweeps that hold its twin conservative: the sweep's frame through
    csrc/composite_fwd.cu agrees with composite_tiles_plain, accum and
    tfinal within 2e-5 and tfinal within TF_RTOL of itself off the latch,
    which a dropped contributing pair would break."""
    _hold_kernel_a_on_sweep(kind, tile)


OFFSET_SCALES = [0.5, 1.0, 3.0, "nonfinite"]
OFFSET_IDS = ["0.5px", "1px", "3px", "nonfinite"]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", OFFSET_SCALES, ids=OFFSET_IDS)
@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_kernel_keeps_the_sweeps_pairs_with_offsets_on_card(kind, tile, scale):
    """As above with subpixel offsets (grid_offsets; `nonfinite` puts NaN
    and inf into some pixels and NaN into a whole warp): the kernel's
    offset-aware box (composite_common.cuh::warp_box_of) on the sweeps
    built around the moved pixels."""
    _hold_kernel_a_on_sweep(kind, tile, grid_offsets(tile, scale))


@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
def test_warp_boxes_bound_each_warps_pixels(tile):
    pixf, boxes, _, _ = _grid(tile)
    T, W = boxes.shape[:2]
    pix = pixf.reshape(T, W, 32, 2)
    lo, hi = pix.amin(2), pix.amax(2)
    want = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
    assert torch.equal(boxes, want)


def test_nonfinite_and_indefinite_inputs_are_never_skipped():
    box = torch.tensor([0.0, 31.0, 0.0, 0.0])
    far = torch.tensor([1e6, 1e6])
    conic = torch.tensor([1.0, 0.0, 1.0])
    op = torch.tensor(0.5)
    assert bool(trc.warp_cull_plain(far, conic, op, box))  # far and definite: skipped
    for bad_conic in ([-1.0, 0.0, 1.0], [1.0, 1.0, 1.0], [1.0, 2.0, 1.0], [0.0, 0.0, 1.0],
                      [np.nan, 0.0, 1.0], [np.inf, 0.0, 1.0]):
        assert not bool(trc.warp_cull_plain(far, torch.tensor(bad_conic), op, box))
    for bad_xy in ([np.nan, 1e6], [np.inf, 0.0]):
        assert not bool(trc.warp_cull_plain(torch.tensor(bad_xy), conic, op, box))
    assert not bool(trc.warp_cull_plain(far, conic, torch.tensor(np.inf), box))
    # below the floor, NaN and negative opacities are skipped exactly
    for low in (np.nextafter(ONE_255, np.float32(0)), np.nan, -1.0, 0.0):
        near = torch.tensor([3.0, 0.0])
        assert bool(trc.warp_cull_plain(near, conic, torch.tensor(low, dtype=torch.float32),
                                        box))
    assert not bool(trc.warp_cull_plain(torch.tensor([3.0, 0.0]), conic,
                                        torch.tensor(ONE_255), box))


@pytest.mark.parametrize("tile", [(32, 16), (16, 16)], ids=["32x16", "16x16"])
def test_cull_skips_a_share_of_a_projected_scene(tile):
    """On the parity scene the twin skips a nonzero share of the pairs that
    the kernel would walk, and none that contributes."""
    from torch_parity import jax_bin, jax_tiles, projected_scene, tt

    from ex4dgs_tpu_torch.ops.binning import Binning
    from ex4dgs_tpu_torch.ops.projection import Projected

    with jax_tiles(*tile):
        j, _ = projected_scene(n=300, seed=0, tile=tile)
        bj = jax_bin(j["proj"], j["gx"], j["gy"], 8192)
    proj = Projected(*(tt(a) for a in j["proj"]))
    b = Binning(**{f: tt(getattr(bj, f)) for f in Binning._fields})
    data, _ = trc.pack_sorted(proj, tt(j["colors"]), tt(j["flow"]), b)
    data = data.detach()
    T = b.tile_start.shape[0]
    tx, ty = tile
    pixf = tile_pixels(j["gx"], T // j["gx"], tx, ty, "cpu")
    boxes = trc.warp_boxes(j["gx"], T, tx, ty, "cpu")
    walked = skipped = 0
    for t in range(T):
        lo, hi = int(b.tile_start[t]), int(b.tile_stop[t])
        if hi <= lo:
            continue
        rows = data[:6, lo:hi].t()
        skip = trc.warp_cull_plain(rows[:, 0:2], rows[:, 2:5], rows[:, 5], boxes[t][:, None])
        ok = torch.ones((1, hi - lo), dtype=torch.bool)
        _, m = comp.chunk_alpha(pixf[t], rows[None, :, 0:2], rows[None, :, 2:5],
                                rows[None, :, 5], ok)
        contributes = m.reshape(-1, 32, hi - lo).any(1)
        assert not bool((skip & contributes).any())
        walked += skip.numel()
        skipped += int(skip.sum())
    assert walked > 0 and 0.1 < skipped / walked < 1.0, (skipped, walked)


def test_library_digest_covers_every_header(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    src = kernels.CSRC / "composite_fwd.cu"
    src.write_text('#include "composite_common.cuh"\n')
    header = kernels.CSRC / "composite_common.cuh"
    header.write_text("// one\n")
    first = kernels.source_digest(src)
    assert kernels.source_digest(src) == first
    (kernels.CSRC / "notes.txt").write_text("not a header")
    assert kernels.source_digest(src) == first
    header.write_text("// two\n")
    second = kernels.source_digest(src)
    assert second != first
    (kernels.CSRC / "other.cuh").write_text("// a new header\n")
    assert kernels.source_digest(src) not in (first, second)


def test_sources_include_only_headers_beside_them():
    """Every header a csrc source includes in quotes lies in csrc/, so the
    digest sees it."""
    import re

    csrc = kernels.Path(kernels.__file__).parent / "csrc"
    for src in sorted(csrc.glob("*.cu*")):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (csrc / inc).is_file() and inc.endswith(".cuh"), (src.name, inc)
