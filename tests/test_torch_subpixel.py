"""The subpixel-offset path of the compositing kernels against the JAX package.

Per-pixel anti-aliasing offsets `off [H, W, 2]` move pixel (x, y) to
(x + off[y, x, 0], y + off[y, x, 1]) before the power (the JAX kernels:
ex4dgs_tpu/ops/rasterize_pallas.py:464-467 and :766-768). Offsets are drawn
from U(-0.5, 0.5) with numpy from a seed, as tests/test_pallas.py draws them.

- `rasterize_tiled_cuda` (on the CPU: the kernels' plain versions) and the
  port's oracle `rasterize_tiled`, at 32x16 and 16x16, against JAX's
  `rasterize_tiled(subpixel_offset=off)`: images to 1e-6, depth to 1e-5,
  identical ids (tests/test_torch_composite.py's tolerances).
- The forward plain version against `_forward_pallas(..., offsets,
  interpret=True)`: accum and tfinal 3e-5, normalised depth and flow 1e-4,
  ids on > 99.5% of pixels (test_plain_matches_pallas_kernel's).
- Kernel B's plain version and its twin against `_backward_pallas(...,
  offsets, interpret=True)` at the strict 2e-5, the twin also against the
  plain version at BWD_RTOL/BWD_ATOL.
- Gradients through CompositeTiles + PackSorted with offsets against
  `jax.grad` of the JAX oracle and of the Pallas path at GRAD_ATOL; the
  offsets get no gradient.
- The offsets move pixels; `render(..., subpixel_offset=off, device="cpu")`
  against JAX's `render` on the same model.
- The offset-aware per-warp cull (csrc/composite_common.cuh::warp_box_of,
  twin `warp_boxes(..., offsets=...)`) is conservative on
  tests/test_torch_cull.py's five sweep kinds at offsets of +-0.5, +-1 and
  +-3 px and its four tiles, and where pixels carry NaN or inf offsets.
  The same frames go through the kernels on the card in the `cuda` cases
  of tests/test_torch_cull.py and tests/test_torch_backward.py.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_subpixel.py
"""
import functools

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch.ops import compositing as comp
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
from ex4dgs_tpu_torch.ops import rasterize_tiled as trt
from test_torch_backward import GRAD_ATOL, _parity_loss
from test_torch_composite import BG, CAP, IMAGE_FIELDS, _normalised, _port_inputs
from test_torch_cull import TILES, _grid, _skips_and_contributions, _sweep, grid_offsets
from torch_parity import H, W

torch.set_num_threads(2)

TILE_PARAMS = dict(params=[(32, 16), (16, 16)], ids=["32x16", "16x16"])
KINDS = ["random", "threshold", "singular", "edges", "nonfinite"]
SCALES = [0.5, 1.0, 3.0]


def _image_offsets(seed=11, height=H, width=W):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (height, width, 2)).astype(np.float32)


def _jax_tile_offsets(off, gx, gy, tile):
    """The JAX package's own tiling of an [H, W, 2] offset image
    (rasterize_pallas.py:1231-1240), in numpy."""
    tx, ty = tile
    h, w = off.shape[:2]
    off = np.pad(off, ((0, gy * ty - h), (0, gx * tx - w), (0, 0)))
    return off.reshape(gy, ty, gx, tx, 2).transpose(0, 2, 1, 3, 4).reshape(gx * gy, ty * tx, 2)


@pytest.fixture(scope="module", **TILE_PARAMS)
def case(request):
    """One random scene at one tile shape with seeded offsets: JAX's oracle
    render with and without them and its Pallas forward with them
    (interpret mode), and the port's inputs."""
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from ex4dgs_tpu.ops import rasterize_tiled as jrt
    from torch_parity import jax_tiles, projected_scene

    tile = request.param
    off = _image_offsets()
    with jax_tiles(*tile):
        j, _ = projected_scene(n=300, seed=0, tile=tile)
        bj, proj, colors, flow, binning = _port_inputs(j)
        data_j, _ = jrp.pack_sorted(j["proj"], j["colors"], j["flow"], bj)
        T = j["gx"] * j["gy"]
        off_tiles = _jax_tile_offsets(off, j["gx"], j["gy"], tile)
        pallas = jrp._forward_pallas(data_j, bj.tile_start, bj.tile_stop,
                                     jnp.arange(T, dtype=jnp.int32), jnp.asarray(off_tiles),
                                     num_tiles=T, grid_x=j["gx"], interpret=True,
                                     track_idx=True)
        oracle = {}
        for name, o in (("off", jnp.asarray(off)), ("none", None)):
            out = jrt.rasterize_tiled(j["proj"], j["colors"], j["flow"], bj, width=W, height=H,
                                      bg=jnp.asarray(BG), max_depth=100.0, chunk=64,
                                      max_per_tile=None, subpixel_offset=o)
            oracle[name] = {k: np.asarray(getattr(out, k)) for k in out._fields}
    return dict(tile=tile, gx=j["gx"], gy=j["gy"], off=off, off_tiles=off_tiles,
                pallas=[np.asarray(a) for a in pallas], oracle=oracle, proj=proj,
                colors=colors, flow=flow, binning=binning)


def _render(case, impl, off):
    kw = dict(width=W, height=H, bg=torch.tensor(BG), max_depth=100.0,
              tile_x=case["tile"][0], tile_y=case["tile"][1],
              subpixel_offset=None if off is None else torch.from_numpy(off))
    args = (case["proj"], case["colors"], case["flow"], case["binning"])
    if impl == "plain":
        return trc.rasterize_tiled_cuda(*args, **kw)
    return trt.rasterize_tiled(*args, chunk=64, **kw)


def test_tile_offsets_match_the_jax_tiling():
    """tile_offsets cuts an image whose size is no multiple of the tile as
    the JAX package does: zero-padded at the right and bottom."""
    off = _image_offsets(seed=3, height=37, width=70)
    for tile in ((32, 16), (16, 16), (8, 4), (24, 4)):
        gx, gy = -(-70 // tile[0]), -(-37 // tile[1])
        got = trc.tile_offsets(torch.from_numpy(off), gx, gy, *tile)
        assert got.is_contiguous() and got.shape == (gx * gy, tile[0] * tile[1], 2)
        np.testing.assert_array_equal(got.numpy(), _jax_tile_offsets(off, gx, gy, tile))


@pytest.mark.parametrize("impl", ["plain", "oracle"])
def test_rasterizers_match_jax_oracle_with_offsets(case, impl):
    out = _render(case, impl, case["off"])
    want = case["oracle"]["off"]
    for name in IMAGE_FIELDS:
        got = getattr(out, name).numpy()
        assert got.shape == want[name].shape, name
        atol = 1e-5 if name == "depth" else 1e-6
        np.testing.assert_allclose(got, want[name], atol=atol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.idx.numpy(), want["idx"])


def test_offsets_move_pixels(case):
    """As tests/test_pallas.py:195: the image with offsets differs from the
    one without by more than 1e-3, in the port and in JAX alike."""
    with_off = _render(case, "plain", case["off"]).color.numpy()
    without = _render(case, "plain", None).color.numpy()
    assert np.abs(with_off - without).max() > 1e-3
    jax_gap = np.abs(case["oracle"]["off"]["color"] - case["oracle"]["none"]["color"]).max()
    assert jax_gap > 1e-3


def test_plain_matches_pallas_kernel_with_offsets(case):
    data, gid = trc.pack_sorted(case["proj"], case["colors"], case["flow"], case["binning"])
    b = case["binning"]
    accum, tfinal, bestidx = (a.numpy() for a in trc.composite_tiles_plain(
        data, gid, b.tile_start, b.tile_stop, grid_x=case["gx"], tile_x=case["tile"][0],
        tile_y=case["tile"][1], offsets=torch.from_numpy(case["off_tiles"])))
    accum_j, tfinal_j, bestidx_j = case["pallas"]
    assert (tfinal < 1).mean() > 0.3  # a non-trivial frame
    np.testing.assert_allclose(accum, accum_j, atol=3e-5, rtol=0)
    np.testing.assert_allclose(tfinal, tfinal_j, atol=3e-5, rtol=0)
    (d, f), (d_j, f_j) = _normalised(accum), _normalised(accum_j)
    np.testing.assert_allclose(d, d_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(f, f_j, atol=1e-4, rtol=0)
    agree = (bestidx == bestidx_j).mean()
    assert agree > 0.995, agree


@pytest.fixture(scope="module", **TILE_PARAMS)
def bwd_case(request):
    """Seeded cotangents on one scene with seeded offsets, through the
    Pallas backward kernel (interpret mode, strict dots) and the port's
    inputs."""
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from torch_parity import backward_inputs, jax_kernel_dot, jax_tiles, projected_scene

    tile = request.param
    with jax_tiles(*tile), jax_kernel_dot("split"):
        j, _ = projected_scene(n=300, seed=0, tile=tile)
        off = _jax_tile_offsets(_image_offsets(), j["gx"], j["gy"], tile)
        ij, it = backward_inputs(j, CAP, tile, offsets=off)
        T = it["starts"].shape[0]
        dgrad_j = jrp._backward_pallas(
            ij["data"], ij["starts"], ij["stops"], jnp.arange(T, dtype=jnp.int32),
            ij["gacc"], ij["acdot"], ij["gend"], ij["tfinal"], ij["offsets"], num_tiles=T,
            grid_x=ij["grid_x"], interpret=True)
    return dict(tile=tile, dgrad_j=np.asarray(dgrad_j), inputs=it)


def _bwd(case, fn, offsets="case"):
    it = case["inputs"]
    return fn(it["data"], it["starts"], it["stops"], it["gacc"], it["acdot"], it["gend"],
              it["tfinal"], grid_x=it["grid_x"], tile_x=case["tile"][0], tile_y=case["tile"][1],
              offsets=it["offsets"] if offsets == "case" else offsets)


@pytest.mark.parametrize("impl", ["plain", "twin"])
def test_backward_matches_pallas_kernel_with_offsets(bwd_case, impl):
    """The plain version and the twin against the TPU kernel at the strict
    2e-5; the twin also against the plain version element by element. The
    offsets change the gradient: without them it differs."""
    fn = trc.composite_tiles_bwd_plain if impl == "plain" else trc.composite_tiles_bwd_walk
    dgrad = _bwd(bwd_case, fn)
    want = bwd_case["dgrad_j"]
    it = bwd_case["inputs"]
    lo, hi = int(it["starts"][0]), int(it["stops"][-1])
    for name, rows in trc.BWD_ROWS.items():
        assert np.abs(want[rows, lo:hi]).max() > 1e-3, name
        np.testing.assert_allclose(dgrad.numpy()[rows, lo:hi], want[rows, lo:hi], atol=2e-5,
                                   rtol=0, err_msg=name)
    assert not dgrad[:, :lo].any() and not dgrad[:, hi:].any() and not dgrad[14:].any()
    if impl == "twin":
        errs = trc.bwd_errors(dgrad, _bwd(bwd_case, trc.composite_tiles_bwd_plain), lo, hi)
        assert all(e[1] <= 1.0 for e in errs.values()), errs
    without = _bwd(bwd_case, fn, offsets=None)
    assert (dgrad - without).abs().max().item() > 1e-3


@pytest.fixture(scope="module", **TILE_PARAMS)
def grad_case(request):
    """jax.grad of the parity loss w.r.t. (colors, flow, opacity, xy, conic)
    with seeded offsets, through the JAX oracle and through the Pallas path
    (interpret mode, strict dots), and the port's inputs."""
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from ex4dgs_tpu.ops import rasterize_tiled as jrt
    from ex4dgs_tpu_torch.ops.projection import Projected
    from torch_parity import (jax_bin, jax_kernel_dot, jax_tiles, port_binning,
                              projected_scene, tt)

    tile = request.param
    bg = (0.1, 0.1, 0.1)
    tgt = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32)
    off = _image_offsets()
    with jax_tiles(*tile), jax_kernel_dot("split"):
        j, _ = projected_scene(n=200, seed=1, tile=tile)
        bj = jax_bin(j["proj"], j["gx"], j["gy"], CAP)
        args = (j["colors"], j["flow"], j["proj"].opacity, j["proj"].xy, j["proj"].conic)

        def loss_with(raster):
            def f(colors, flow, opac, xy, conic):
                p = j["proj"]._replace(opacity=opac, xy=xy, conic=conic)
                out = raster(p, colors, flow, bj, width=W, height=H, bg=jnp.asarray(bg),
                             max_depth=100.0, subpixel_offset=jnp.asarray(off))
                return _parity_loss("jax", out, jnp.asarray(tgt))
            return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4)))

        oracle = loss_with(lambda *a, **k: jrt.rasterize_tiled(*a, chunk=64, **k))(*args)
        pallas = loss_with(lambda *a, **k: jrp.rasterize_tiled_pallas(*a, interpret=True,
                                                                      **k))(*args)
    proj = Projected(*(tt(a) for a in j["proj"]))
    binning = port_binning(bj)
    as_np = lambda vg: (float(vg[0]), [np.asarray(g) for g in vg[1]])  # noqa: E731
    return dict(tile=tile, bg=bg, tgt=tgt, off=off, proj=proj, binning=binning,
                args=[tt(a) for a in args], oracle=as_np(oracle), pallas=as_np(pallas))


def _port_value_and_grads(case, impl):
    """The parity loss and its gradients through the port; the offsets are
    a leaf that requires grad, and must get none."""
    xs = [a.clone().requires_grad_(True) for a in case["args"]]
    off = torch.from_numpy(case["off"]).requires_grad_(True)
    proj = case["proj"]._replace(opacity=xs[2], xy=xs[3], conic=xs[4])
    kw = dict(width=W, height=H, bg=torch.tensor(case["bg"]), max_depth=100.0,
              tile_x=case["tile"][0], tile_y=case["tile"][1], subpixel_offset=off)
    if impl == "composite":
        out = trc.rasterize_tiled_cuda(proj, xs[0], xs[1], case["binning"], track_idx=False,
                                       **kw)
    else:
        out = trt.rasterize_tiled(proj, xs[0], xs[1], case["binning"], chunk=64, **kw)
    loss = _parity_loss("torch", out, torch.tensor(case["tgt"]))
    *grads, g_off = torch.autograd.grad(loss, [*xs, off], allow_unused=True)
    assert g_off is None  # the offsets are data (JAX: a zero cotangent)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("impl", ["composite", "oracle"])
def test_gradients_match_jax_oracle_with_offsets(grad_case, impl):
    value, grads = _port_value_and_grads(grad_case, impl)
    want_value, want = grad_case["oracle"]
    np.testing.assert_allclose(value, want_value, rtol=1e-6, atol=1e-7)
    for (name, atol), g, w in zip(GRAD_ATOL.items(), grads, want):
        assert np.abs(w).max() > 1e-4, name  # a non-trivial gradient
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def test_gradients_match_pallas_path_with_offsets(grad_case):
    value, grads = _port_value_and_grads(grad_case, "composite")
    want_value, want = grad_case["pallas"]
    np.testing.assert_allclose(value, want_value, rtol=1e-5, atol=1e-6)
    for (name, atol), g, w in zip(GRAD_ATOL.items(), grads, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def scene():
    from ex4dgs_tpu import synthetic as jsyn
    from ex4dgs_tpu_torch.models import config as tcfg
    from torch_parity import port_camera, port_model

    jm, jc = jsyn.make_scene(n_static=1200, n_dynamic=150, duration=10.0, seed=5,
                             static_capacity=1280, dynamic_capacity=160, opacity=0.5)
    jcam = jsyn.ring_cameras(3, 3.0, W, H, far=jc.far)[1]
    return jm, jc, jcam, port_model(jm), tcfg.ModelConfig(**vars(jc)), port_camera(jcam)


@functools.lru_cache(maxsize=None)
def _jax_render(cfg):
    import jax

    from ex4dgs_tpu import rendering as jr

    return jax.jit(functools.partial(jr.render, cfg=cfg, backend="jnp", capacity=CAP))


@pytest.mark.parametrize("t", [0.0, 2.5])
def test_render_with_offsets_matches_jax(scene, t):
    """render(..., subpixel_offset=off) of the port (the kernels' plain
    versions) against JAX's render with the same offsets, at the
    tolerances of tests/test_torch_render.py."""
    import jax.numpy as jnp

    from ex4dgs_tpu_torch import rendering as tr

    jm, jc, jcam, tm, tc, tcam = scene
    off = _image_offsets(seed=5)
    want = _jax_render(jc)(jcam, jm, t=jnp.asarray(t, jnp.float32), bg=jnp.asarray(BG),
                           subpixel_offset=jnp.asarray(off))
    got = tr.render(tcam, tm, tc, t=t, bg=BG, capacity=CAP, device="cpu",
                    subpixel_offset=torch.from_numpy(off))
    plain = tr.render(tcam, tm, tc, t=t, bg=BG, capacity=CAP, device="cpu")
    assert int(got.binning_total) == int(want.binning_total) <= CAP
    assert float(got.acc.mean()) > 0.1
    for name in ("render", "depth", "opticalflow", "acc"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, atol=1e-4 if name == "depth" else 1e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(got.dominent_idxs.numpy(), np.asarray(want.dominent_idxs))
    assert (got.render - plain.render).abs().max().item() > 1e-3


def test_render_rejects_offsets_it_cannot_take(scene):
    from ex4dgs_tpu_torch import rendering as tr

    *_, tm, tc, tcam = scene
    kw = dict(t=1.0, bg=BG, capacity=CAP, device="cpu")
    for bad in (torch.zeros((H, W + 1, 2)), torch.zeros((H, W, 2), dtype=torch.float64),
                torch.zeros((W, H, 2))):
        with pytest.raises(ValueError):
            tr.render(tcam, tm, tc, subpixel_offset=bad, **kw)


@pytest.mark.parametrize("scale", SCALES, ids=[f"{s:g}px" for s in SCALES])
@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
@pytest.mark.parametrize("kind", KINDS)
def test_offset_cull_is_conservative(kind, tile, scale):
    """No (tile, warp, instance) that the twin of the offset-aware cull
    skips has a moved pixel of the warp at which chunk_alpha's exact test
    passes; the sweeps (built on the moved pixels) mean something."""
    off = grid_offsets(tile, scale)
    xy, conic, op = _sweep(kind, tile, offsets=off)
    skip, contributes = _skips_and_contributions(xy, conic, op, tile, off)
    dropped = skip & contributes
    assert not bool(dropped.any()), f"{int(dropped.sum())} contributing pairs skipped"
    assert bool(contributes.any()) and bool(skip.any())


@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
@pytest.mark.parametrize("kind", ["random", "threshold", "singular"])
def test_offset_cull_with_nonfinite_offsets(kind, tile):
    """Pixels whose offset holds NaN, inf or -inf pass no instance's exact
    test and are left out of their warp's box; the warp whose 32 pixels are
    all NaN gets the inverted infinite box, which skips exactly the
    instances below the opacity floor. The cull stays conservative."""
    off = grid_offsets(tile, "nonfinite")
    xy, conic, op = _sweep(kind, tile, offsets=off)
    pixf, boxes, _, _ = _grid(tile, off)
    bad = ~torch.isfinite(pixf).all(-1)  # [T, P]
    assert bool(bad.any()) and not bool(bad.all())
    ok = torch.ones((1, 1, len(op)), dtype=torch.bool)
    _, m = comp.chunk_alpha(pixf, *(torch.from_numpy(a)[None, None] for a in (xy, conic, op)),
                            ok)
    assert not bool(m[bad].any())
    inf = float("inf")
    assert boxes[1, 0].tolist() == [inf, -inf, inf, -inf]
    skip, contributes = _skips_and_contributions(xy, conic, op, tile, off)
    assert not bool((skip & contributes).any())
    assert torch.equal(skip[1, 0], ~(torch.from_numpy(op) >= comp.ALPHA_MIN))
    assert bool(contributes.any()) and bool(skip.any())


@pytest.mark.parametrize("tile", TILES, ids=[f"{x}x{y}" for x, y in TILES])
def test_offset_warp_boxes_bound_each_warps_pixels(tile):
    """The box of warp_boxes(..., offsets) is the least and largest rounded
    coordinate centre + offset over the warp's finite pixels, so it bounds
    every one of them; with zero offsets it is the integer box."""
    T = _grid(tile)[0].shape[0]
    for scale in (*SCALES, "nonfinite"):
        off = grid_offsets(tile, scale)
        pixf, boxes, _, _ = _grid(tile, off)
        pix = pixf.reshape(T, -1, 32, 2)
        good = torch.isfinite(pix).all(-1)
        for c, (lo_i, hi_i) in enumerate(((0, 1), (2, 3))):
            v = pix[..., c]
            lo, hi = boxes[..., lo_i, None], boxes[..., hi_i, None]
            assert bool(((v >= lo) & (v <= hi))[good].all())
            has = good.any(-1)
            assert torch.equal(torch.where(good, v, torch.inf).amin(-1)[has], lo[..., 0][has])
            assert torch.equal(torch.where(good, v, -torch.inf).amax(-1)[has], hi[..., 0][has])
    zero = torch.zeros((T, tile[0] * tile[1], 2))
    assert torch.equal(_grid(tile, zero)[1], _grid(tile)[1])
