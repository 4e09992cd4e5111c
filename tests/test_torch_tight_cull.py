"""The tight corner-tile cull of ex4dgs_tpu_torch's binning against the JAX
package's (KernelConfig.tight_cull; tests/test_tight_cull.py on the port).

The cull sends an instance whose alpha a box bound proves below the 1/255
floor over its whole tile to the sentinel tile. The compositor skips every
sample below that floor, so the cull may change no output and no gradient:

- the culled set is JAX's (`bin_gaussians` with the cull on, every field
  equal), it fires, `total` is unchanged, the cull only removes (in order),
  and every removed instance's largest alpha over its tile's pixels, on a
  half-pixel grid enlarged by the 1 px margin, is below 1/255
  (tests/test_tight_cull.py:61);
- images and gradients through the port's oracle and its render path (the
  kernels' plain versions), with and without subpixel offsets, cull on
  against off, at tests/test_tight_cull.py:113's tolerances: removing an
  instance moves the later ones within the plain versions' 64-wide chunks,
  and the chunk's sums pair their (equal) terms otherwise;
- bit for bit where the walk is one instance at a time, as the kernels walk
  (kernel A's plain version at chunk 1, kernel B's twin
  `composite_tiles_bwd_walk` and the pack VJP), with and without offsets;
- with offsets, the render path cull on against JAX's Pallas forward with
  the cull on, in interpret mode (tests/test_tight_cull.py:159), at
  tests/test_torch_composite.py's kernel tolerances;
- the option reaches the binning of `render` and `train_step` through
  `kernel_cfg`, and `KernelConfig.from_dict` reads JAX's record of it.

The `cuda` case holds kernels A and B bit-equal with the cull on and off on
the card.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tight_cull.py
"""
import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
from ex4dgs_tpu_torch.ops import rasterize_tiled as trt
from ex4dgs_tpu_torch.ops.binning import Binning, bin_gaussians
from ex4dgs_tpu_torch.ops.compositing import ALPHA_MIN

torch.set_num_threads(2)

CAP = 8192
BG = (0.15, 0.25, 0.35)
TILE_PARAMS = dict(params=[(32, 16), (16, 16)], ids=["32x16", "16x16"])


def _bin(proj, gx, gy, tile, tight):
    return bin_gaussians(proj, gx, gy, CAP, tight_cull=tight, tile_x=tile[0], tile_y=tile[1])


def _composited(b):
    return int((b.tile_stop - b.tile_start).sum())


def _offsets(seed, h, w):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (h, w, 2)).astype(np.float32)


@pytest.fixture(scope="module", **TILE_PARAMS)
def case(request):
    """A random scene of tests/scenes.py projected by both packages at one
    tile shape, and JAX's binning of it with the cull on."""
    from torch_parity import jax_bin, jax_config, jax_tiles, projected_scene

    tile = request.param
    with jax_tiles(*tile):
        j, t = projected_scene(n=300, seed=0, tile=tile)
        with jax_config(tight_cull=True):
            bj = jax_bin(j["proj"], j["gx"], j["gy"], CAP)
    return dict(tile=tile, j=j, t=t, jax_on=bj)


def test_cull_matches_jax_and_is_conservative(case):
    from torch_parity import H, W, as_np

    tile, t = case["tile"], case["t"]
    proj, gx, gy = t["proj"], t["gx"], t["gy"]
    b_off = _bin(proj, gx, gy, tile, False)
    b_on = _bin(proj, gx, gy, tile, True)
    for f in Binning._fields[:-1]:  # all but the port's own `slot`
        np.testing.assert_array_equal(as_np(getattr(b_on, f)),
                                      np.asarray(getattr(case["jax_on"], f)), err_msg=f)
    assert int(b_on.total) == int(b_off.total)  # overflow accounting unchanged
    assert _composited(b_on) < _composited(b_off), "the cull removed nothing"

    xy, conic = proj.xy.numpy(), proj.conic.numpy()
    opac = (proj.opacity * proj.valid).numpy()
    tx, ty = tile
    margin, checked = 1.0, 0
    for tl in range(gx * gy):
        kept = b_on.order[b_on.tile_start[tl]:b_on.tile_stop[tl]].tolist()
        full = b_off.order[b_off.tile_start[tl]:b_off.tile_stop[tl]].tolist()
        assert set(kept) <= set(full)  # the cull only removes
        assert kept == [g for g in full if g in set(kept)]  # in order
        row, col = divmod(tl, gx)
        us = np.arange(col * tx - margin, col * tx + tx + margin + 0.5, 0.5)
        vs = np.arange(row * ty - margin, row * ty + ty + margin + 0.5, 0.5)
        uu, vv = np.meshgrid(us, vs)
        for g in set(full) - set(kept):
            du, dv = uu - xy[g, 0], vv - xy[g, 1]
            q = conic[g, 0] * du * du + 2 * conic[g, 1] * du * dv + conic[g, 2] * dv * dv
            amax = opac[g] * np.exp(-0.5 * q.min())
            assert amax < ALPHA_MIN, (tl, g, amax)
            checked += 1
    assert checked > 0 and W % tx == 0 and H % ty == 0


def _loss_grads(case, impl, binning, off):
    """(loss, image, grads of xy, conic, opacity, colors) through the port's
    oracle or its render path (on the CPU, the kernels' plain versions)."""
    from torch_parity import H, W

    tile, t = case["tile"], case["t"]
    leaves = [t["proj"].xy.clone().requires_grad_(), t["proj"].conic.clone().requires_grad_(),
              t["proj"].opacity.clone().requires_grad_(), t["colors"].clone().requires_grad_()]
    p = t["proj"]._replace(xy=leaves[0], conic=leaves[1], opacity=leaves[2])
    kw = dict(width=W, height=H, bg=torch.tensor(BG), max_depth=100.0, tile_x=tile[0],
              tile_y=tile[1], subpixel_offset=None if off is None else torch.from_numpy(off))
    if impl == "oracle":
        out = trt.rasterize_tiled(p, leaves[3], t["flow"], binning, chunk=64, **kw)
    else:
        out = trc.rasterize_tiled_cuda(p, leaves[3], t["flow"], binning, **kw)
    tgt = torch.from_numpy(np.random.default_rng(5).uniform(size=(H, W, 3)).astype(np.float32))
    loss = (out.color - tgt).abs().mean()
    loss.backward()
    return loss.detach(), out.color.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("impl", ["oracle", "plain"])
@pytest.mark.parametrize("subpixel", [False, True], ids=["no_offsets", "offsets"])
def test_cull_leaves_images_and_grads(case, impl, subpixel):
    from torch_parity import H, W

    t, tile = case["t"], case["tile"]
    off = _offsets(11, H, W) if subpixel else None
    outs = {tight: _loss_grads(case, impl, _bin(t["proj"], t["gx"], t["gy"], tile, tight), off)
            for tight in (False, True)}
    (l0, img0, g0), (l1, img1, g1) = outs[False], outs[True]
    np.testing.assert_allclose(img1.numpy(), img0.numpy(), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=2e-6, atol=1e-9)
    for a, b, name in zip(g1, g0, ("xy", "conic", "opacity", "colors")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("subpixel", [False, True], ids=["no_offsets", "offsets"])
def test_cull_is_bitwise_one_instance_at_a_time(case, subpixel):
    """Kernel A's plain version at chunk 1, kernel B's twin and the pack VJP
    (the kernels' order of operations): every output and every
    per-Gaussian gradient row bit-equal with the cull on and off, and the
    pack VJP reads the same cotangent at every expansion slot (so the
    kernel, whose order of sums follows the slots alone, sums them alike
    on the card)."""
    from torch_parity import H, W

    t, tile = case["t"], case["tile"]
    proj, gx, gy = t["proj"], t["gx"], t["gy"]
    offsets = None
    if subpixel:
        offsets = trc.tile_offsets(torch.from_numpy(_offsets(11, H, W)), gx, gy, *tile)
    grid = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1], offsets=offsets)
    got = {}
    for tight in (False, True):
        b = _bin(proj, gx, gy, tile, tight)
        rows = torch.stack([proj.xy[:, 0], proj.xy[:, 1], *proj.conic.unbind(1),
                            proj.opacity * proj.valid, *t["colors"].unbind(1), proj.depth,
                            *t["flow"].unbind(1), torch.ones_like(proj.depth),
                            torch.zeros_like(proj.depth), torch.zeros_like(proj.depth)])
        rows.requires_grad_()
        data = trc.PackSorted.apply(rows, b.order, b.cum, b.counts, b.slot)
        gid = b.order.to(torch.int32)
        accum, tfinal, best = trc.composite_tiles_plain(data.detach(), gid, b.tile_start,
                                                        b.tile_stop, chunk=1, **grid)
        gen = torch.Generator().manual_seed(3)
        gacc = torch.randn(accum.shape, generator=gen)
        gend = torch.randn(tfinal.shape, generator=gen)
        acdot = (accum[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
        dgrad = trc.composite_tiles_bwd_walk(data.detach(), b.tile_start, b.tile_stop, gacc,
                                             acdot, gend, tfinal, **grid)
        g_rows, = torch.autograd.grad(data, rows, grad_outputs=dgrad)
        # the pack VJP's input: the cotangent columns in expansion order
        by_slot = torch.zeros_like(dgrad)
        by_slot[:, b.slot.long()] = dgrad
        got[tight] = (accum, tfinal, best, g_rows, by_slot)
    for a, b, name in zip(got[True], got[False], ("accum", "tfinal", "bestidx", "grad rows",
                                                  "input by slot")):
        assert torch.equal(a, b), name
    assert got[False][3].abs().max() > 0


def test_pack_vjp_slot_order_is_the_gaussian_sort(case):
    """Binning.slot is the expansion order of a stable sort of the Gaussian
    ids where nothing is culled (tests/torch_parity.py::expansion_slots,
    which gives binnings made from the JAX package's arrays their slots);
    with the cull on, the pack VJP by the slots gives the cull-off rows
    bit for bit (each instance's cotangent drawn once, in the expansion
    order, zero on the culled instances and past the last one)."""
    from torch_parity import expansion_slots

    t, tile = case["t"], case["tile"]
    proj = t["proj"]
    b = {tight: _bin(proj, t["gx"], t["gy"], tile, tight) for tight in (False, True)}
    assert torch.equal(b[False].slot, expansion_slots(b[False].order))
    gen = torch.Generator().manual_seed(7)
    rows = torch.randn((16, proj.xy.shape[0]), generator=gen)
    n = int(b[False].total)
    by_slot = torch.randn((16, CAP), generator=gen)
    by_slot[:, n:] = 0
    culled = b[True].slot[:n][b[True].tile_id[:n] == t["gx"] * t["gy"]].long()
    assert culled.numel() > 0
    by_slot[:, culled] = 0
    grads = {}
    for tight in (False, True):
        r = rows.clone().requires_grad_()
        bt = b[tight]
        data = trc.PackSorted.apply(r, bt.order, bt.cum, bt.counts, bt.slot)
        grads[tight] = torch.autograd.grad(data, r, grad_outputs=by_slot[:, bt.slot.long()])[0]
    assert torch.equal(grads[True], grads[False]) and grads[False].abs().max() > 0


def test_cull_with_offsets_matches_jax_pallas(case):
    """With offsets and the cull on, the render path's forward (plain
    version) against JAX's Pallas forward on JAX's culled binning, in
    interpret mode: accum and tfinal within 3e-5, ids on > 99.5% of
    pixels; and against the port's own run with the cull off."""
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from torch_parity import H, W, jax_tiles
    from test_torch_subpixel import _jax_tile_offsets

    j, t, tile = case["j"], case["t"], case["tile"]
    gx, gy = t["gx"], t["gy"]
    off = _offsets(13, H, W)
    bj = case["jax_on"]
    with jax_tiles(*tile):
        data_j, _ = jrp.pack_sorted(j["proj"], j["colors"], j["flow"], bj)
        T = gx * gy
        want = jrp._forward_pallas(data_j, bj.tile_start, bj.tile_stop,
                                   jnp.arange(T, dtype=jnp.int32),
                                   jnp.asarray(_jax_tile_offsets(off, gx, gy, tile)),
                                   num_tiles=T, grid_x=gx, interpret=True, track_idx=True)
    offsets = trc.tile_offsets(torch.from_numpy(off), gx, gy, *tile)
    outs = {}
    for tight in (False, True):
        b = _bin(t["proj"], gx, gy, tile, tight)
        data, gid = trc.pack_sorted(t["proj"], t["colors"], t["flow"], b)
        outs[tight] = trc.composite_tiles_fwd(data.detach(), gid, b.tile_start, b.tile_stop,
                                              grid_x=gx, tile_x=tile[0], tile_y=tile[1],
                                              offsets=offsets)
    accum, tfinal, best = outs[True]
    np.testing.assert_allclose(accum.numpy(), np.asarray(want[0]), atol=3e-5)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(want[1]), atol=3e-5)
    assert (best.numpy() == np.asarray(want[2])).mean() > 0.995
    np.testing.assert_allclose(accum.numpy(), outs[False][0].numpy(), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(tfinal.numpy(), outs[False][1].numpy(), rtol=2e-6, atol=1e-6)


def test_kernel_config_carries_the_cull(monkeypatch):
    """`render` and `train_step` bin with the kernel config's cull, and
    from_dict reads the JAX package's record of it."""
    from ex4dgs_tpu.kernel_config import KernelConfig as JKernelConfig
    from ex4dgs_tpu_torch import rendering
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.ops import binning
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
    from ex4dgs_tpu_torch.train.step import StepStatics, train_step

    jrec = JKernelConfig(tight_cull=True).to_json()
    import json

    assert KernelConfig.from_dict(json.loads(jrec)).tight_cull
    assert not KernelConfig.from_dict({}).tight_cull
    assert json.loads(KernelConfig(tight_cull=True).to_json())["tight_cull"] is True

    seen = []
    real = binning.bin_gaussians

    def spy(*a, **kw):
        seen.append(kw["tight_cull"])
        return real(*a, **kw)

    monkeypatch.setattr(binning, "bin_gaussians", spy)
    model, cfg = make_scene(n_static=200, n_dynamic=20, duration=4.0, seed=2, device="cpu")
    cam = ring_cameras(1, 3.0, 64, 48, far=cfg.far, device="cpu")[0]
    outs = {}
    for tight in (False, True):
        kcfg = KernelConfig(tight_cull=tight)
        r = rendering.render(cam, model, cfg, t=1.0, bg=torch.zeros(3), capacity=65536,
                             kernel_cfg=kcfg, device="cpu")
        st = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                         capacity=65536, kernel=kcfg)
        s = train_step(model, init_state(model.params, device="cpu"), cam,
                       torch.full((48, 64, 3), 0.3), 1.0, torch.zeros(3), 100, st, device="cpu")
        outs[tight] = (r, s)
    assert seen == [False, False, True, True]
    np.testing.assert_allclose(outs[True][0].render.numpy(), outs[False][0].render.numpy(),
                               rtol=2e-6, atol=1e-7)
    assert int(outs[True][0].binning_total) == int(outs[False][0].binning_total)
    for k, v in outs[False][1].model.params.items():
        np.testing.assert_allclose(outs[True][1].model.params[k].numpy(), v.numpy(),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("subpixel", [False, True], ids=["no_offsets", "offsets"])
def test_kernels_bitwise_with_the_cull_on_card(cuda_device, subpixel):
    """Kernels A and B on a small scene's frame, binned with the cull on and
    off: outputs bit-equal, and the gradient rows through the pack VJP
    bit-equal."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.rendering import preprocess_points
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras

    dev = cuda_device
    model, cfg = make_scene(n_static=3000, n_dynamic=300, duration=10.0, seed=1, device=dev)
    cam = ring_cameras(1, 3.0, 320, 192, far=cfg.far, device=dev)[0]
    with torch.no_grad():
        proj, colors = preprocess_points(point_data_at_t(model, cfg, 2.5), cam, cfg,
                                         near=cfg.near, far=cfg.far)
    gx, gy = tile_grid(cam.width, cam.height)
    offsets = None
    if subpixel:
        off = torch.from_numpy(_offsets(11, cam.height, cam.width)).to(dev)
        offsets = trc.tile_offsets(off, gx, gy, 32, 16)
    flow = torch.zeros_like(colors)
    got = {}
    for tight in (False, True):
        b = bin_gaussians(proj, gx, gy, 1 << 18, tight_cull=tight)
        rows = torch.stack([proj.xy[:, 0], proj.xy[:, 1], *proj.conic.unbind(1),
                            proj.opacity * proj.valid, *colors.unbind(1), proj.depth,
                            *flow.unbind(1), torch.ones_like(proj.depth),
                            torch.zeros_like(proj.depth), torch.zeros_like(proj.depth)])
        rows.requires_grad_()
        data = trc.PackSorted.apply(rows, b.order, b.cum, b.counts, b.slot)
        kw = dict(grid_x=gx, tile_x=32, tile_y=16, offsets=offsets)
        accum, tfinal, best = kernels.composite_fwd(data.detach(), b.order.to(torch.int32),
                                                    b.tile_start, b.tile_stop, track_idx=True,
                                                    **kw)
        gen = torch.Generator(device=dev).manual_seed(3)
        gacc = torch.randn(accum.shape, device=dev, generator=gen)
        gend = torch.randn(tfinal.shape, device=dev, generator=gen)
        acdot = (accum[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
        dgrad = kernels.composite_bwd(data.detach(), b.tile_start, b.tile_stop, gacc, acdot,
                                      gend, tfinal, **kw)
        g_rows, = torch.autograd.grad(data, rows, grad_outputs=dgrad)
        got[tight] = (accum, tfinal, best, g_rows, _composited(b))
    for a, b, name in zip(got[True][:4], got[False][:4], ("accum", "tfinal", "bestidx", "rows")):
        assert torch.equal(a, b), name
    assert got[True][4] < got[False][4]
