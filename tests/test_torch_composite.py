"""ex4dgs_tpu_torch forward compositing against the JAX package.

`pack_sorted` must give the JAX package's rows 0-13 bit for bit, and `gid`
must equal its row 14 read as int32. The kernel's plain version
`composite_tiles_plain` is held against the TPU kernel itself
(`_forward_pallas(..., interpret=True)`) at the tolerances the JAX package
holds that kernel to (tests/test_pallas.py): accum and tfinal 3e-5 (the
kernel's transmittance goes through one log-space matmul), depth and flow
1e-4, dominant ids on > 99.5% of pixels (the kernel breaks weight ties by
minimum id, the oracle by depth order). Against the JAX oracle
`rasterize_tiled`, which blends with the same sequential chunked product,
the images agree to 1e-6 and the dominant ids exactly.

The JAX side is imported inside the fixtures, so the CUDA case at the end
also runs on a machine that has the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_composite.py
"""
import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
from ex4dgs_tpu_torch.ops import rasterize_tiled as trt
from ex4dgs_tpu_torch.ops.binning import bin_gaussians
from ex4dgs_tpu_torch.ops.projection import Projected
from ex4dgs_tpu_torch.ops.rasterize_tiled import tile_pixels

torch.set_num_threads(2)

W, H = 96, 64
CAP = 8192
BG = (0.2, 0.3, 0.4)
IMAGE_FIELDS = ("color", "depth", "flow", "acc", "final_t")


def _port_inputs(j):
    """The JAX projection and binning as port tensors, so only what follows
    them is under test."""
    from torch_parity import jax_bin, port_binning, tt

    bj = jax_bin(j["proj"], j["gx"], j["gy"], CAP)
    proj = Projected(*(tt(a) for a in j["proj"]))
    binning = port_binning(bj)
    return bj, proj, tt(j["colors"]), tt(j["flow"]), binning


@pytest.fixture(scope="module", params=[(32, 16), (16, 16)], ids=["32x16", "16x16"])
def case(request):
    """One random scene at one tile shape: the JAX package's packed buffer,
    Pallas forward (interpret mode) and oracle render, and the port's
    inputs."""
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from ex4dgs_tpu.ops import rasterize_tiled as jrt
    from torch_parity import jax_tiles, projected_scene

    tile = request.param
    with jax_tiles(*tile):
        j, _ = projected_scene(n=300, seed=0, tile=tile)
        bj, proj, colors, flow, binning = _port_inputs(j)
        data_j, gid_j = jrp.pack_sorted(j["proj"], j["colors"], j["flow"], bj)
        T = j["gx"] * j["gy"]
        pallas = jrp._forward_pallas(data_j, bj.tile_start, bj.tile_stop,
                                     jnp.arange(T, dtype=jnp.int32), num_tiles=T,
                                     grid_x=j["gx"], interpret=True, track_idx=True)
        oracle = jrt.rasterize_tiled(j["proj"], j["colors"], j["flow"], bj, width=W,
                                     height=H, bg=jnp.asarray(BG), max_depth=100.0,
                                     chunk=64, max_per_tile=None)
    return dict(tile=tile, gx=j["gx"], data_j=np.asarray(data_j), gid_j=np.asarray(gid_j),
                pallas=[np.asarray(a) for a in pallas],
                oracle={k: np.asarray(getattr(oracle, k)) for k in oracle._fields},
                proj=proj, colors=colors, flow=flow, binning=binning)


def _plain(case, track_idx=True):
    data, gid = trc.pack_sorted(case["proj"], case["colors"], case["flow"], case["binning"])
    b = case["binning"]
    return trc.composite_tiles_plain(data, gid, b.tile_start, b.tile_stop, grid_x=case["gx"],
                                     tile_x=case["tile"][0], tile_y=case["tile"][1],
                                     track_idx=track_idx)


def _normalised(accum):
    """(depth, flow) from an accum block, as rasterize_tiled_cuda forms them."""
    acc = accum[..., 7]
    denom = np.where(acc > 0, acc, 1.0)
    return (np.where(acc > 0, accum[..., 3] / denom, 100.0),
            np.where(acc[..., None] > 0, accum[..., 4:7] / denom[..., None], 0.0))


def test_pack_sorted_matches_jax(case):
    data, gid = trc.pack_sorted(case["proj"], case["colors"], case["flow"], case["binning"])
    assert data.shape == (16, CAP) and data.dtype == torch.float32 and data.is_contiguous()
    assert gid.shape == (CAP,) and gid.dtype == torch.int32
    # bit for bit: compare the float rows as their int32 bit patterns
    np.testing.assert_array_equal(data[:14].numpy().view(np.int32),
                                  case["data_j"][:14].view(np.int32))
    np.testing.assert_array_equal(gid.numpy(), case["data_j"][14].view(np.int32))
    np.testing.assert_array_equal(gid.numpy(), case["gid_j"])
    assert not data[14:].any()


def test_plain_matches_pallas_kernel(case):
    accum, tfinal, bestidx = (a.numpy() for a in _plain(case))
    accum_j, tfinal_j, bestidx_j = case["pallas"]
    assert accum.shape == accum_j.shape and tfinal.shape == tfinal_j.shape
    assert (tfinal < 1).mean() > 0.3  # a non-trivial frame
    np.testing.assert_allclose(accum, accum_j, atol=3e-5, rtol=0)
    np.testing.assert_allclose(tfinal, tfinal_j, atol=3e-5, rtol=0)
    (d, f), (d_j, f_j) = _normalised(accum), _normalised(accum_j)
    np.testing.assert_allclose(d, d_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(f, f_j, atol=1e-4, rtol=0)
    agree = (bestidx == bestidx_j).mean()
    assert agree > 0.995, agree


@pytest.mark.parametrize("impl", ["plain", "oracle"])
def test_rasterizers_match_jax_oracle(case, impl):
    """rasterize_tiled_cuda (on the CPU: the plain version) and the port's
    own oracle rasterize_tiled, both against the JAX oracle."""
    kw = dict(width=W, height=H, bg=torch.tensor(BG), max_depth=100.0,
              tile_x=case["tile"][0], tile_y=case["tile"][1])
    args = (case["proj"], case["colors"], case["flow"], case["binning"])
    if impl == "plain":
        out = trc.rasterize_tiled_cuda(*args, **kw)
    else:
        out = trt.rasterize_tiled(*args, chunk=64, **kw)
    want = case["oracle"]
    for name in IMAGE_FIELDS:
        got = getattr(out, name).numpy()
        assert got.shape == want[name].shape, name
        atol = 1e-5 if name == "depth" else 1e-6  # depth ~ 2-8 scene units
        np.testing.assert_allclose(got, want[name], atol=atol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.idx.numpy(), want["idx"])


def test_track_idx_false_gives_minus_one(case):
    accum_t, tfinal_t, _ = _plain(case, track_idx=True)
    accum_f, tfinal_f, bestidx_f = _plain(case, track_idx=False)
    assert bestidx_f.dtype == torch.int32 and bool((bestidx_f == -1).all())
    assert torch.equal(accum_f, accum_t) and torch.equal(tfinal_f, tfinal_t)
    out = trc.rasterize_tiled_cuda(case["proj"], case["colors"], case["flow"],
                                   case["binning"], width=W, height=H,
                                   bg=torch.tensor(BG), max_depth=100.0,
                                   tile_x=case["tile"][0], tile_y=case["tile"][1],
                                   track_idx=False)
    assert bool((out.idx == -1).all())


def test_cpu_tensors_take_the_plain_version(case):
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    data, gid = trc.pack_sorted(case["proj"], case["colors"], case["flow"], case["binning"])
    b = case["binning"]
    before = dict(kernels.launches)
    got = trc.composite_tiles_fwd(data, gid, b.tile_start, b.tile_stop, grid_x=case["gx"],
                                  tile_x=case["tile"][0], tile_y=case["tile"][1])
    assert kernels.launches == before
    for a, w in zip(got, _plain(case)):
        assert torch.equal(a, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _adversarial_frame(tile, device, grid=(4, 3), per_tile=320, seed=5):
    """A packed frame built to catch a dropped pair: in every tile, splats
    whose means straddle the warps' row boundaries, thin ellipses (axis
    ratio 10-1000), and opacities that put a splat's best pixel of the tile
    within a few 1e-7 of the alpha floor. Returns (data [16, C], gid [C],
    starts, stops, grid_x); numpy from a seed, no JAX."""
    rng = np.random.default_rng(seed)
    tx, ty = tile
    gx, gy = grid
    cols = []
    counts = rng.integers(per_tile // 2, per_tile + 1, gx * gy)
    counts[1] = 0  # an empty tile
    for t, n in enumerate(counts):
        x0, y0 = (t % gx) * tx, (t // gx) * ty
        px, py = np.meshgrid(np.arange(tx) + x0, np.arange(ty) + y0)
        pix = np.stack([px.ravel(), py.ravel()], -1).astype(np.float64)
        kind = rng.integers(0, 3, n)
        rows_per_warp = max(1, 32 // tx)
        edge = y0 + rows_per_warp * rng.integers(0, max(1, ty // rows_per_warp), n)
        xy = np.stack([rng.uniform(x0 - 12, x0 + tx + 12, n),
                       np.where(kind == 0, edge - rng.choice([0.5, 1.0, 0.0], n),
                                rng.uniform(y0 - 12, y0 + ty + 12, n))], -1)
        size = np.exp(rng.uniform(np.log(0.5), np.log(15.0), n))
        ratio = np.where(kind == 1, 10.0 ** rng.uniform(1, 3, n), 10.0 ** rng.uniform(0, 0.5, n))
        th = rng.uniform(0, np.pi, n)
        c, s_ = np.cos(th), np.sin(th)
        l1, l2 = 1 / size**2, 1 / (size * ratio) ** 2
        conic = np.stack([c * c * l1 + s_ * s_ * l2, c * s_ * (l1 - l2),
                          s_ * s_ * l1 + c * c * l2], -1).astype(np.float32)
        xy = xy.astype(np.float32)
        d = xy[:, None, :].astype(np.float64) - pix[None]
        cf = conic.astype(np.float64)[:, None]
        q = cf[..., 0] * d[..., 0] ** 2 + 2 * cf[..., 1] * d[..., 0] * d[..., 1] \
            + cf[..., 2] * d[..., 1] ** 2
        floor = np.exp(np.minimum(q.min(1) / 2, 5.5)) / 255 \
            * (1 + rng.choice([-1e-6, -1e-7, 0.0, 1e-7, 1e-6], n))
        op = np.where(kind == 2, floor, rng.uniform(0.05, 1.0, n))
        col = np.zeros((16, n), np.float32)
        col[0:2], col[2:5], col[5] = xy.T, conic.T, op
        col[6:9] = rng.uniform(0, 1, (3, n))
        col[9] = np.sort(rng.uniform(1, 10, n))
        col[10:13] = rng.normal(size=(3, n))
        col[13] = 1.0
        cols.append(col)
    data = np.concatenate(cols, 1)
    stops = np.cumsum(counts).astype(np.int32)
    starts = (stops - counts).astype(np.int32)
    gid = np.arange(data.shape[1], dtype=np.int32)
    return (torch.from_numpy(data).to(device), torch.from_numpy(gid).to(device),
            torch.from_numpy(starts).to(device), torch.from_numpy(stops).to(device), gx)


def _scene_frame(tile, device):
    """A packed frame of a small make_scene render at t = 2.5."""
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.rendering import preprocess_points
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras

    kcfg = KernelConfig(tile_x=tile[0], tile_y=tile[1])
    model, cfg = make_scene(n_static=4000, n_dynamic=400, seed=3, device=device)
    cam = ring_cameras(1, 3.0, 200, 120, far=cfg.far, device=device)[0]
    pts = point_data_at_t(model, cfg, 2.5)
    proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far,
                                     kernel_cfg=kcfg)
    gx, gy = tile_grid(cam.width, cam.height, *tile)
    binning = bin_gaussians(proj, gx, gy, 1 << 17)
    assert int(binning.total) <= 1 << 17
    flow = torch.zeros((proj.xy.shape[0], 3), device=device)
    data, gid = trc.pack_sorted(proj, colors, flow, binning)
    return data.detach(), gid, binning.tile_start, binning.tile_stop, gx


def test_adversarial_frame_is_meaningful():
    """The adversarial frame's near-threshold splats sit on both sides of
    the alpha floor, and the plain version composites it (on the CPU)."""
    tile = (16, 16)
    data, gid, starts, stops, gx = _adversarial_frame(tile, "cpu")
    accum, tfinal, bestidx = trc.composite_tiles_plain(data, gid, starts, stops, grid_x=gx,
                                                       tile_x=16, tile_y=16)
    assert bool(torch.isfinite(accum).all()) and (tfinal < 1).float().mean() > 0.3
    assert bool((tfinal[1] == 1).all()) and bool((bestidx[1] == -1).all())  # the empty tile
    pixf = tile_pixels(gx, starts.shape[0] // gx, 16, 16, "cpu").double()
    below = above = 0
    for t in range(starts.shape[0]):
        r = data[:6, starts[t]:stops[t]].double()
        d = r[None, 0:2].permute(0, 2, 1) - pixf[t][:, None, :]  # [P, n, 2]
        q = r[2] * d[..., 0] ** 2 + 2 * r[3] * d[..., 0] * d[..., 1] + r[4] * d[..., 1] ** 2
        best = r[5] * torch.exp(-q.amin(0) / 2) * 255  # best alpha of the tile, x 255
        below += int(((best < 1) & (best > 1 - 2e-6)).sum())
        above += int(((best >= 1) & (best < 1 + 2e-6)).sum())
    assert below > 50 and above > 50, (below, above)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["scene", "adversarial"])
@pytest.mark.parametrize("tile", [(32, 16), (16, 16), (8, 4), (24, 4)],
                         ids=["32x16", "16x16", "8x4", "24x4"])
def test_kernel_at_tile0_matches_plain_on_card(cuda_device, frame, tile):
    """The slab branch: the frame's tiles from tile0 = grid_x + 1 (a first
    tile that does not start a row, so that a mix-up of the global and the
    local tile index shows in x as well as in y) through the kernel at that
    tile0, against the plain version at the same tile0 (as
    test_kernel_matches_plain_on_card), bit-equal to the whole frame's
    kernel rows, and unlike the kernel at tile0 = 0 on the same ranges."""
    make = _scene_frame if frame == "scene" else _adversarial_frame
    data, gid, starts, stops, gx = make(tile, cuda_device)
    t0 = gx + 1
    assert t0 % gx and t0 < starts.shape[0]
    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1], track_idx=True)
    args = (data, gid, starts[t0:].contiguous(), stops[t0:].contiguous())
    before = kernels.launches["composite_fwd"]
    got = trc.composite_tiles_fwd(*args, tile0=t0, **kw)
    whole = trc.composite_tiles_fwd(data, gid, starts, stops, **kw)
    at_zero = trc.composite_tiles_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["composite_fwd"] == before + 3
    assert all(torch.equal(a, w[t0:]) for a, w in zip(got, whole))
    assert not torch.equal(got[0], at_zero[0])
    want = trc.composite_tiles_plain(*args, tile0=t0, **kw)
    for a, w in zip(got[:2], want[:2]):
        assert (a - w).abs().max().item() <= 2e-5
    rel, _ = trc.tfinal_rel_err(got[1], want[1])
    assert rel <= trc.TF_RTOL, rel
    assert (got[2] == want[2]).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["scene", "adversarial"])
@pytest.mark.parametrize("tile", [(32, 16), (16, 16), (8, 4), (24, 4)],
                         ids=["32x16", "16x16", "8x4", "24x4"])
@pytest.mark.parametrize("track_idx", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, frame, tile, track_idx):
    """csrc/composite_fwd.cu against composite_tiles_plain on the same
    packed buffer, on the card: accum and tfinal within 2e-5 (the same
    per-pair arithmetic; the kernel accumulates features with fused
    multiply-adds), tfinal also within TF_RTOL of itself off the latch (a
    contributing pair that the per-warp cull dropped would move it by at
    least 1/255 of itself; trc.tfinal_rel_err), ids on >= 99.9% of pixels,
    and two launches bit-equal. The adversarial frame puts splats across
    warp rows, thin ellipses and opacities on the alpha floor; at 24x4 a
    warp wraps across two rows."""
    make = _scene_frame if frame == "scene" else _adversarial_frame
    data, gid, starts, stops, gx = make(tile, cuda_device)
    args = (data, gid, starts, stops)
    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1], track_idx=track_idx)
    before = kernels.launches["composite_fwd"]
    got = trc.composite_tiles_fwd(*args, **kw)
    again = trc.composite_tiles_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["composite_fwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = trc.composite_tiles_plain(*args, **kw)
    for a, w, atol in zip(got[:2], want[:2], (2e-5, 2e-5)):
        assert a.shape == w.shape and bool(torch.isfinite(a).all())
        assert (a - w).abs().max().item() <= atol
    rel, _ = trc.tfinal_rel_err(got[1], want[1])
    assert rel <= trc.TF_RTOL, rel
    agree = (got[2] == want[2]).float().mean().item()
    assert agree >= 0.999, agree
    if not track_idx:
        assert bool((got[2] == -1).all())
