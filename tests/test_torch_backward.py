"""ex4dgs_tpu_torch backward compositing against the JAX package.

- The backward kernel's plain version `composite_tiles_bwd_plain` against the
  TPU kernel itself (`_backward_pallas(..., interpret=True)`) on the same
  packed buffer and seeded cotangents, under the strict in-kernel dot
  precision ("split"), at the JAX suite's strict backward tolerance 2e-5
  (tests/test_pallas.py); columns outside every tile's range are zero.
- End to end, through `CompositeTiles` and `PackSorted` (rasterize_tiled_cuda
  on CPU tensors), against `jax.grad` of the JAX oracle and of the Pallas
  path, for the loss of tests/test_pallas.py::_backward_parity_case: colors,
  flow and opacity at 2e-5, xy and conic at 3e-5.
- The port's own oracle (`ops/rasterize_tiled.py`, autograd through
  `blend_chunk`) against the same `jax.grad`: before the port took the JAX
  package's gradient semantics (straight-through clamp, detached aux
  weights, detached acc) its opacity gradient was off by 0.045.
- The pack gather's VJP against the JAX package's, in both of its modes, and
  at a production-size buffer against a float64 oracle.

The CUDA cases at the end need the card (the JAX side is imported inside the
fixtures, so they also run where there is no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_backward.py
"""
import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
from ex4dgs_tpu_torch.ops import rasterize_tiled as trt

torch.set_num_threads(2)

W, H = 96, 64
CAP = 8192
TILE_PARAMS = dict(params=[(32, 16), (16, 16)], ids=["32x16", "16x16"])
ROWS = {"xy": slice(0, 2), "conic": slice(2, 5), "opacity": slice(5, 6),
        "features": slice(6, 14)}
GRAD_ATOL = {"colors": 2e-5, "flow": 2e-5, "opacity": 2e-5, "xy": 3e-5, "conic": 3e-5}


@pytest.fixture(scope="module", **TILE_PARAMS)
def bwd_case(request):
    """Seeded cotangents on one scene, through the Pallas backward kernel
    (interpret mode, strict dots) and the port's inputs."""
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from torch_parity import backward_inputs, jax_kernel_dot, jax_tiles, projected_scene

    tile = request.param
    with jax_tiles(*tile), jax_kernel_dot("split"):
        j, _ = projected_scene(n=300, seed=0, tile=tile)
        ij, it = backward_inputs(j, CAP, tile)
        T = it["starts"].shape[0]
        dgrad_j = jrp._backward_pallas(
            ij["data"], ij["starts"], ij["stops"], jnp.arange(T, dtype=jnp.int32),
            ij["gacc"], ij["acdot"], ij["gend"], ij["tfinal"], num_tiles=T,
            grid_x=ij["grid_x"], interpret=True)
    return dict(tile=tile, dgrad_j=np.asarray(dgrad_j), inputs=it)


def _plain_bwd(case):
    it = case["inputs"]
    return trc.composite_tiles_bwd_plain(
        it["data"], it["starts"], it["stops"], it["gacc"], it["acdot"], it["gend"],
        it["tfinal"], grid_x=it["grid_x"], tile_x=case["tile"][0], tile_y=case["tile"][1])


def test_plain_backward_matches_pallas_kernel(bwd_case):
    dgrad = _plain_bwd(bwd_case).numpy()
    want = bwd_case["dgrad_j"]
    it = bwd_case["inputs"]
    lo, hi = int(it["starts"][0]), int(it["stops"][-1])
    assert dgrad.shape == want.shape == (16, CAP) and hi - lo > 300
    for name, rows in ROWS.items():
        assert np.abs(want[rows, lo:hi]).max() > 1e-3, name  # a non-trivial gradient
        np.testing.assert_allclose(dgrad[rows, lo:hi], want[rows, lo:hi], atol=2e-5, rtol=0,
                                   err_msg=name)
    assert not dgrad[:, :lo].any() and not dgrad[:, hi:].any() and not dgrad[14:].any()


def test_cpu_tensors_take_the_plain_backward(bwd_case):
    it = bwd_case["inputs"]
    before = dict(kernels.launches)
    got = trc.composite_tiles_bwd(it["data"], it["starts"], it["stops"], it["gacc"],
                                  it["acdot"], it["gend"], it["tfinal"], grid_x=it["grid_x"],
                                  tile_x=bwd_case["tile"][0], tile_y=bwd_case["tile"][1])
    assert kernels.launches == before
    assert torch.equal(got, _plain_bwd(bwd_case))


def _parity_loss(xp, out, tgt):
    """The loss of tests/test_pallas.py::_backward_parity_case: L1 on color,
    a flow hook weighted by the detached acc, and the mean depth."""
    if xp == "jax":
        import jax
        import jax.numpy as jnp

        hook = jax.lax.stop_gradient(jnp.stack([out.acc] * 3, -1))
        return jnp.abs(out.color - tgt).mean() + (out.flow * hook).sum() * 1e-3 \
            + out.depth.mean() * 1e-3
    hook = torch.stack([out.acc] * 3, -1).detach()
    return (out.color - tgt).abs().mean() + (out.flow * hook).sum() * 1e-3 \
        + out.depth.mean() * 1e-3


@pytest.fixture(scope="module", **TILE_PARAMS)
def grad_case(request):
    """jax.grad of the parity loss w.r.t. (colors, flow, opacity, xy, conic)
    through the JAX oracle and through the Pallas path (interpret mode,
    strict dots), and the port's inputs."""
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from ex4dgs_tpu.ops import rasterize_tiled as jrt
    from ex4dgs_tpu_torch.ops.binning import Binning
    from ex4dgs_tpu_torch.ops.projection import Projected
    from torch_parity import jax_bin, jax_kernel_dot, jax_tiles, projected_scene, tt

    tile = request.param
    bg = (0.1, 0.1, 0.1)
    tgt = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32)
    with jax_tiles(*tile), jax_kernel_dot("split"):
        j, _ = projected_scene(n=200, seed=1, tile=tile)
        bj = jax_bin(j["proj"], j["gx"], j["gy"], CAP)
        args = (j["colors"], j["flow"], j["proj"].opacity, j["proj"].xy, j["proj"].conic)

        def loss_with(raster):
            def f(colors, flow, opac, xy, conic):
                p = j["proj"]._replace(opacity=opac, xy=xy, conic=conic)
                out = raster(p, colors, flow, bj, width=W, height=H, bg=jnp.asarray(bg),
                             max_depth=100.0)
                return _parity_loss("jax", out, jnp.asarray(tgt))
            return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4)))

        oracle = loss_with(lambda *a, **k: jrt.rasterize_tiled(*a, chunk=64, **k))(*args)
        pallas = loss_with(lambda *a, **k: jrp.rasterize_tiled_pallas(*a, interpret=True,
                                                                      **k))(*args)
    proj = Projected(*(tt(a) for a in j["proj"]))
    binning = Binning(**{f: tt(getattr(bj, f)) for f in Binning._fields})
    as_np = lambda vg: (float(vg[0]), [np.asarray(g) for g in vg[1]])  # noqa: E731
    return dict(tile=tile, bg=bg, tgt=tgt, proj=proj, binning=binning,
                args=[tt(a) for a in args], oracle=as_np(oracle), pallas=as_np(pallas))


def _port_value_and_grads(case, impl):
    xs = [a.clone().requires_grad_(True) for a in case["args"]]
    proj = case["proj"]._replace(opacity=xs[2], xy=xs[3], conic=xs[4])
    kw = dict(width=W, height=H, bg=torch.tensor(case["bg"]), max_depth=100.0,
              tile_x=case["tile"][0], tile_y=case["tile"][1])
    if impl == "composite":
        out = trc.rasterize_tiled_cuda(proj, xs[0], xs[1], case["binning"], track_idx=False,
                                       **kw)
    else:
        out = trt.rasterize_tiled(proj, xs[0], xs[1], case["binning"], chunk=64, **kw)
    loss = _parity_loss("torch", out, torch.tensor(case["tgt"]))
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, xs)]


@pytest.mark.parametrize("impl", ["composite", "oracle"])
def test_gradients_match_jax_oracle(grad_case, impl):
    """`composite`: CompositeTiles + PackSorted, the training path.
    `oracle`: autograd through the port's blend_chunk; this is the case
    whose opacity gradient was off by 0.045 (largest JAX gradient 0.0082)
    before the port took the JAX gradient semantics."""
    value, grads = _port_value_and_grads(grad_case, impl)
    want_value, want = grad_case["oracle"]
    np.testing.assert_allclose(value, want_value, rtol=1e-6, atol=1e-7)
    for (name, atol), g, w in zip(GRAD_ATOL.items(), grads, want):
        assert np.abs(w).max() > 1e-4, name  # a non-trivial gradient
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def test_gradients_match_pallas_path(grad_case):
    value, grads = _port_value_and_grads(grad_case, "composite")
    want_value, want = grad_case["pallas"]
    np.testing.assert_allclose(value, want_value, rtol=1e-5, atol=1e-6)
    for (name, atol), g, w in zip(GRAD_ATOL.items(), grads, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def _pack_case(P, cap, seed):
    """A pack gather's inputs: per-Gaussian counts (some zero), the order of
    a shuffled expansion with a tail that clips to the last Gaussian, and
    cotangent columns zero past the last instance (CompositeTiles zeroes
    them)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 11 if cap < 10**5 else 17, P).astype(np.int32)
    counts[rng.integers(0, P, 5)] = 0
    cum = np.cumsum(counts, dtype=np.int64)
    total = int(cum[-1])
    assert total <= cap
    order = np.full(cap, P - 1, np.int32)
    order[:total] = np.repeat(np.arange(P, dtype=np.int32), counts)[rng.permutation(total)]
    cols = rng.normal(size=(P, 16)).astype(np.float32)
    ct = rng.normal(size=(16, cap)).astype(np.float32)
    ct[:, total:] = 0.0
    return cols, order, cum.astype(np.int32), counts, ct


def _port_pack_vjp(cols, order, cum, counts, ct):
    rows = torch.tensor(cols.T.copy(), requires_grad=True)
    data = trc.PackSorted.apply(rows, torch.tensor(order), torch.tensor(cum),
                                torch.tensor(counts))
    (g,) = torch.autograd.grad((data * torch.tensor(ct)).sum(), [rows])
    return g.numpy().T  # [P, 16]


def _jax_pack_vjp(cols, order, cum, counts, ct):
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp

    def f(c):
        return (jrp._gather_rows_t(c, jnp.asarray(order), jnp.asarray(cum),
                                   jnp.asarray(counts)) * ct).sum()

    return np.asarray(jax.grad(f)(jnp.asarray(cols)))


@pytest.mark.parametrize("mode", ["segment", "scatter"])
def test_pack_vjp_matches_jax(mode):
    from torch_parity import jax_config

    case = _pack_case(53, 512, seed=3)
    with jax_config(pack_vjp=mode):
        want = _jax_pack_vjp(*case)
    got = _port_pack_vjp(*case)
    # row 14 of the JAX buffer carries the ids, not cols[:, 14]: its
    # cotangent is not cols' gradient there
    np.testing.assert_allclose(np.delete(got, 14, 1), np.delete(want, 14, 1), atol=2e-5,
                               rtol=0)


def test_pack_vjp_at_production_capacity():
    """A 2M-slot buffer (tests/test_pallas.py's precision probe): the port's
    float64 prefix against a float64 scatter-add and against the JAX
    package's two-level float32 segment VJP."""
    from torch_parity import jax_config

    cap = 2 * 1024 * 1024
    cols, order, cum, counts, ct = _pack_case(cap // 9, cap, seed=7)
    got = _port_pack_vjp(cols, order, cum, counts, ct)
    ref = np.zeros(cols.shape)
    total = int(cum[-1])
    np.add.at(ref, order[:total], ct[:, :total].T.astype(np.float64))
    # float64 segment sums rounded once to float32: within half an ulp
    np.testing.assert_allclose(got, ref, rtol=6e-8, atol=1e-12)
    with jax_config(pack_vjp="segment"):
        want = _jax_pack_vjp(cols, order, cum, counts, ct)
    np.testing.assert_allclose(np.delete(got, 14, 1), np.delete(want, 14, 1), atol=2e-5,
                               rtol=0)


def test_pack_vjp_is_deterministic_and_skips_the_tail():
    cols, order, cum, counts, ct = _pack_case(40, 384, seed=5)
    total = int(cum[-1])
    ct_tail = ct.copy()
    ct_tail[:, total:] = 1e3  # the tail aliases Gaussian P-1 through the clipped order
    a = _port_pack_vjp(cols, order, cum, counts, ct)
    assert np.array_equal(a, _port_pack_vjp(cols, order, cum, counts, ct))
    assert np.array_equal(a, _port_pack_vjp(cols, order, cum, counts, ct_tail))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(32, 16), (16, 16)], ids=["32x16", "16x16"])
def test_backward_kernel_matches_plain_on_card(cuda_device, tile):
    """csrc/composite_bwd.cu against composite_tiles_bwd_plain on the same
    inputs and O(1) cotangents, on the card: element by element
    |kernel - plain| within 1e-5 |plain| + 1e-6 max |plain| of its row group
    (the kernel sums the pixels in another order), zero outside every range,
    and two launches bit-equal (no atomics)."""
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.binning import bin_gaussians
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.rendering import preprocess_points
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras

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
    data = data.detach()
    starts, stops = binning.tile_start, binning.tile_stop
    accum, tfinal, _ = trc.composite_tiles_fwd(data, gid, starts, stops, grid_x=gx,
                                               tile_x=tile[0], tile_y=tile[1], track_idx=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    gacc = torch.randn(accum.shape, device=dev, generator=gen)
    gend = torch.randn(tfinal.shape, device=dev, generator=gen)
    acdot = (accum[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
    args = (data, starts, stops, gacc, acdot, gend, tfinal)
    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1])
    before = kernels.launches["composite_bwd"]
    got = trc.composite_tiles_bwd(*args, **kw)
    again = trc.composite_tiles_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["composite_bwd"] == before + 2
    assert torch.equal(got, again)
    want = trc.composite_tiles_bwd_plain(*args, **kw)
    lo, hi = int(starts[0]), int(stops[-1])
    assert bool(torch.isfinite(got).all())
    for name, rows in ROWS.items():
        w = want[rows, lo:hi].abs()
        limit = 1e-5 * w + 1e-6 * w.max()
        err = (got[rows, lo:hi] - want[rows, lo:hi]).abs()
        assert bool((err <= limit).all()), (name, (err / limit.clamp_min(1e-30)).max().item())
    assert not got[:, :lo].any() and not got[:, hi:].any() and not got[14:].any()
