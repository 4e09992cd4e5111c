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
from ex4dgs_tpu_torch.ops.binning import Binning, bin_gaussians
from ex4dgs_tpu_torch.ops.projection import Projected

torch.set_num_threads(2)

W, H = 96, 64
CAP = 8192
BG = (0.2, 0.3, 0.4)
IMAGE_FIELDS = ("color", "depth", "flow", "acc", "final_t")


def _port_inputs(j):
    """The JAX projection and binning as port tensors, so only what follows
    them is under test."""
    from torch_parity import jax_bin, tt

    bj = jax_bin(j["proj"], j["gx"], j["gy"], CAP)
    proj = Projected(*(tt(a) for a in j["proj"]))
    binning = Binning(**{f: tt(getattr(bj, f)) for f in Binning._fields})
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


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(32, 16), (16, 16)], ids=["32x16", "16x16"])
@pytest.mark.parametrize("track_idx", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, tile, track_idx):
    """csrc/composite_fwd.cu against composite_tiles_plain on the same
    packed buffer, on the card: accum and tfinal within 2e-5 (the same
    per-pair arithmetic; the kernel accumulates features with fused
    multiply-adds), ids on >= 99.9% of pixels."""
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.rendering import preprocess_points
    from ex4dgs_tpu_torch.kernel_config import KernelConfig

    dev = cuda_device
    kcfg = KernelConfig(tile_x=tile[0], tile_y=tile[1])
    model, cfg = make_scene(n_static=4000, n_dynamic=400, seed=3, device=dev)
    cam = ring_cameras(1, 3.0, 200, 120, far=cfg.far, device=dev)[0]
    pts = point_data_at_t(model, cfg, 2.5)
    proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far,
                                     kernel_cfg=kcfg)
    gx, gy = tile_grid(cam.width, cam.height, *tile)
    binning = bin_gaussians(proj, gx, gy, 1 << 17)
    assert int(binning.total) <= 1 << 17
    flow = torch.zeros((proj.xy.shape[0], 3), device=dev)
    data, gid = trc.pack_sorted(proj, colors, flow, binning)
    args = (data, gid, binning.tile_start, binning.tile_stop)
    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1], track_idx=track_idx)
    before = kernels.launches["composite_fwd"]
    got = trc.composite_tiles_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["composite_fwd"] == before + 1
    want = trc.composite_tiles_plain(*args, **kw)
    for a, w, atol in zip(got[:2], want[:2], (2e-5, 2e-5)):
        assert a.shape == w.shape and bool(torch.isfinite(a).all())
        assert (a - w).abs().max().item() <= atol
    agree = (got[2] == want[2]).float().mean().item()
    assert agree >= 0.999, agree
    if not track_idx:
        assert bool((got[2] == -1).all())
