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

- The per-warp cull is conservative for gradients, not only for colours: an
  instance that `warp_cull_plain` skips in every warp of its tile has an
  all-zero column in the plain backward, on the cull's near-threshold and
  near-singular sweep frames (tests/test_torch_cull.py) and on the parity
  scene.
- A numpy twin of the backward kernel's transposed warp reduction
  (csrc/composite_bwd.cu::warp_sum_transposed) leaves each of the 16 values'
  warp sums in the two lanes the kernel reads it from (2r and 2r + 1).
- Kernel B's hard frames (the cull's near-threshold and near-singular
  sweeps, the adversarial frame of tests/test_torch_composite.py) at 16x16,
  held to JAX: the TPU kernel (`_backward_pallas(interpret=True)`, strict
  dots) and `jax.grad` of the jnp oracle's blend in float32 are JAX's two
  float32 evaluations, and `jax.grad` of the same blend in float64 is the
  reference they are measured against. On pixels where an alpha-floor,
  power-sign or latch decision lies within float32 rounding, two
  implementations may decide differently (their exp and sums round
  differently) and an instance's whole column then differs; those pixels
  get zero cotangents, so they reach no sum, and on the others the port and
  JAX decide every test alike. There the twin and the plain version stay
  within HARD_FRAME_RATIO times JAX's own float32 error.
  `python tests/test_torch_backward.py` prints the numbers.

The CUDA cases at the end need the card (the JAX side is imported inside the
fixtures, so they also run where there is no JAX): the kernel against its
plain version on a scene, on the cull's sweep frames and on the adversarial
frame of tests/test_torch_composite.py, at 32x16, 16x16, 8x4 and 24x4:

    python -m pytest --noconftest -m cuda tests/test_torch_backward.py
"""
import re

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
ROWS = trc.BWD_ROWS
CARD_TILES = [(32, 16), (16, 16), (8, 4), (24, 4)]
CARD_IDS = [f"{x}x{y}" for x, y in CARD_TILES]
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


def test_walk_twin_matches_pallas_kernel_and_plain(bwd_case):
    """composite_tiles_bwd_walk, the kernel's twin (its arithmetic and its
    order of sums), against the TPU kernel at the strict 2e-5 and against
    the plain version element by element at BWD_RTOL/BWD_ATOL."""
    it = bwd_case["inputs"]
    args = (it["data"], it["starts"], it["stops"], it["gacc"], it["acdot"], it["gend"],
            it["tfinal"])
    twin = trc.composite_tiles_bwd_walk(*args, grid_x=it["grid_x"], tile_x=bwd_case["tile"][0],
                                        tile_y=bwd_case["tile"][1])
    lo, hi = int(it["starts"][0]), int(it["stops"][-1])
    want = bwd_case["dgrad_j"]
    for name, rows in ROWS.items():
        np.testing.assert_allclose(twin.numpy()[rows, lo:hi], want[rows, lo:hi], atol=2e-5,
                                   rtol=0, err_msg=name)
    errs = trc.bwd_errors(twin, _plain_bwd(bwd_case), lo, hi)
    assert all(e[1] <= 1.0 for e in errs.values()), errs
    assert not twin[:, :lo].any() and not twin[:, hi:].any() and not twin[14:].any()


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
    from ex4dgs_tpu_torch.ops.projection import Projected
    from torch_parity import (jax_bin, jax_kernel_dot, jax_tiles, port_binning,
                              projected_scene, tt)

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
    binning = port_binning(bj)
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
    from torch_parity import expansion_slots

    order_t = torch.tensor(order)
    data = trc.PackSorted.apply(rows, order_t, torch.tensor(cum), torch.tensor(counts),
                                expansion_slots(order_t))
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
    float64 segment sums against a float64 scatter-add and against the JAX
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


def _one_range_per_tile(data, starts, stops):
    """A frame whose tiles share one instance range (the cull's sweep
    frames) with a copy of the range for every tile: the backward writes
    each instance's column from its one tile."""
    T, n = starts.shape[0], int(stops[0] - starts[0])
    assert bool((starts == starts[0]).all()) and bool((stops == stops[0]).all())
    cols = data[:, int(starts[0]):int(stops[0])].repeat(1, T)
    first = torch.arange(T, dtype=torch.int32, device=data.device) * n
    return cols.contiguous(), first, first + n


def _numpy_cotangents(T, npix, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(T, npix, 8)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(T, npix, 1)).astype(np.float32)))


def _assert_culled_columns_zero(data, starts, stops, dgrad, grid_x, tile):
    """Every instance that warp_cull_plain skips in every warp of its tile
    has an all-zero gradient column; the frame holds such instances and
    non-zero columns of kept ones."""
    T = starts.shape[0]
    boxes = trc.warp_boxes(grid_x, T, *tile, "cpu")
    culled = kept_nonzero = 0
    for t in range(T):
        lo, hi = int(starts[t]), int(stops[t])
        if hi <= lo:
            continue
        rows = data[:6, lo:hi].t()
        skip = trc.warp_cull_plain(rows[:, 0:2], rows[:, 2:5], rows[:, 5], boxes[t][:, None])
        everywhere = skip.all(0)  # [n]
        cols = dgrad[:, lo:hi]
        assert bool((cols[:, everywhere] == 0).all()), (t, int(everywhere.sum()))
        culled += int(everywhere.sum())
        kept_nonzero += int(cols[:, ~everywhere].any(0).sum())
    assert culled > 0 and kept_nonzero > 0, (culled, kept_nonzero)


@pytest.mark.parametrize("tile", CARD_TILES, ids=CARD_IDS)
@pytest.mark.parametrize("kind", ["threshold", "singular"])
def test_culled_instances_have_zero_gradients_on_sweep_frames(kind, tile):
    """The cull's near-threshold and near-singular sweeps (one copy of the
    sweep per tile), through the plain forward and backward with seeded
    O(1) cotangents: the cull is conservative for the gradient rows."""
    from test_torch_cull import _sweep_frame

    data, gid, starts, stops, gx = _sweep_frame(kind, tile)
    data, starts, stops = _one_range_per_tile(data, starts, stops)
    gid = torch.arange(data.shape[1], dtype=torch.int32)
    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1])
    accum, tfinal, _ = trc.composite_tiles_plain(data, gid, starts, stops, **kw)
    gacc, gend = _numpy_cotangents(*accum.shape[:2])
    acdot = (accum[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
    dgrad = trc.composite_tiles_bwd_plain(data, starts, stops, gacc, acdot, gend, tfinal, **kw)
    assert bool(torch.isfinite(dgrad).all())
    _assert_culled_columns_zero(data, starts, stops, dgrad, gx, tile)


def test_culled_instances_have_zero_gradients_on_the_parity_scene(bwd_case):
    it = bwd_case["inputs"]
    _assert_culled_columns_zero(it["data"], it["starts"], it["stops"], _plain_bwd(bwd_case),
                                it["grid_x"], bwd_case["tile"])


def _transposed_warp_sum(v):
    """Numpy twin of csrc/composite_bwd.cu::warp_sum_transposed: v float32
    [32 lanes, 16 values]; returns what each lane's call returns. At the
    level of lane bit 2h (h = 8, 4, 2, 1) a lane keeps values [h, 2h) if
    its bit is set, else [0, h), and adds what its partner (lane ^ 2h)
    sends: the other half of the partner's first 2h; the xor-1 level adds
    the pair's two sums."""
    v = v.astype(np.float32).copy()
    lanes = np.arange(32)
    for h in (8, 4, 2, 1):
        upper = ((lanes & (2 * h)) != 0)[:, None]
        keep = np.where(upper, v[:, h:2 * h], v[:, :h])
        send = np.where(upper, v[:, :h], v[:, h:2 * h])
        v[:, :h] = keep + send[lanes ^ (2 * h)]
    return v[:, 0] + v[lanes ^ 1, 0]


def test_transposed_reduction_twin_matches_the_kernel_source():
    """The twin's levels and lane map are the kernel's: levels 8, 4, 2, 1
    then xor 1 (16 shuffles), and row r written by the even lane 2r."""
    src = (kernels.CSRC / "composite_bwd.cu").read_text()
    body = src[src.index("float warp_sum_transposed"):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"transpose_level<(\d+)>\(v, lane\)", body) == ["8", "4", "2", "1"]
    assert "v[0] + __shfl_xor_sync(kFull, v[0], 1)" in body
    assert "v[k] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf)" in src
    assert "const float keep = upper ? v[k + kHalf] : v[k];" in src
    assert "const int row = lane >> 1;" in src
    assert "if (!(lane & 1) && row < kOut) s_part[(warp * kBatch + i) * kPartStride + row] = sum;" \
        in src
    assert "constexpr int kVals = 16;" in src and "constexpr int kOut = 14;" in src


@pytest.mark.parametrize("kind", ["normal", "integers", "one_lane", "some_lanes"])
def test_transposed_reduction_leaves_each_sum_in_its_lanes(kind):
    """Lanes 2r and 2r + 1 hold value r's sum over the 32 lanes, bit-equal
    to each other; the padding values 14 and 15 (zero) leave lanes 28-31
    zero. Integer values (any order exact) and a single non-zero lane give
    the sums exactly; seeded normal values within the rounding of 31 adds."""
    rng = np.random.default_rng({"normal": 0, "integers": 1, "one_lane": 2, "some_lanes": 3}[kind])
    v = np.zeros((32, 16), np.float32)
    if kind == "integers":
        v[:, :14] = rng.integers(-1000, 1000, (32, 14))
    else:
        v[:, :14] = rng.normal(size=(32, 14)) * 10.0 ** rng.uniform(-3, 3, (32, 14))
    if kind == "one_lane":
        v[np.arange(32) != 13] = 0.0
    elif kind == "some_lanes":
        v[rng.permutation(32)[:24]] = 0.0
    out = _transposed_warp_sum(v)
    assert np.array_equal(out[0::2].view(np.int32), out[1::2].view(np.int32))
    want = v.astype(np.float64).sum(0)
    got = out[0::2].astype(np.float64)  # value r in lane 2r
    assert np.all(got[14:] == 0.0)
    if kind in ("integers", "one_lane"):
        assert np.array_equal(got, want)
    else:
        bound = 32 * np.finfo(np.float32).eps * np.abs(v).astype(np.float64).sum(0)
        assert np.all(np.abs(got - want) <= bound)
        assert not np.array_equal(got[:14], np.zeros(14))


# The port's largest error against the float64 reference, per row group, may
# reach this multiple of JAX's own largest float32 error (of its TPU kernel
# and of its float32 jnp blend) on the hard frames. Measured: up to 1.7x on
# the near-singular sweep (xy and opacity). There b^2 -> ac makes the power a
# difference of large terms, and the port rounds each of its products and
# sums (the kernels' pinned arithmetic) where XLA fuses some of them; with
# the power alone taken in float64 the port's error falls below JAX's.
HARD_FRAME_RATIO = trc.HARD_FRAME_RATIO
HARD_KINDS = ["threshold", "singular", "adversarial"]
_U = 2.0 ** -24


def _hard_frame(kind, tile=(16, 16)):
    """(data [16, C], starts, stops, grid_x) of a hard frame on the CPU: a
    sweep with one copy of its range per tile, or the adversarial frame."""
    if kind == "adversarial":
        from test_torch_composite import _adversarial_frame

        data, _, starts, stops, gx = _adversarial_frame(tile, "cpu")
        return data, starts, stops, gx
    from test_torch_cull import _sweep_frame

    data, _, starts, stops, gx = _sweep_frame(kind, tile)
    return (*_one_range_per_tile(data, starts, stops), gx)


def _undecided_pixels(data, starts, stops, grid_x, tile):
    """bool [T, P]: pixels with a pair whose float32 decisions lie within
    rounding, judged in float64 with the rounding bound of
    composite_common.cuh (a rounded power is within 4u M of the exact one,
    M = |a dx^2| + |c dy^2| + 2 |b dx dy|, u = 2^-24): the alpha floor
    within 16u (M + 1) in log space, a power within 8u M of 0 off the
    pixel's own centre, or a transmittance within 1e-3 (log) of T_EPS,
    where sums of many roundings land."""
    T = starts.shape[0]
    pix = trc.tile_pixels(grid_x, T // grid_x, *tile, "cpu").double().numpy()
    d = data.double().numpy()
    out = np.zeros((T, pix.shape[1]), bool)
    for t in range(T):
        lo, hi = int(starts[t]), int(stops[t])
        if hi <= lo:
            continue
        r = d[:, lo:hi]
        dx = r[0][None] - pix[t][:, 0:1]
        dy = r[1][None] - pix[t][:, 1:2]
        qa, qb, qc = r[2] * dx * dx, r[3] * dx * dy, r[4] * dy * dy
        power = -0.5 * (qa + qc) - qb
        m_scale = np.abs(qa) + np.abs(qc) + 2 * np.abs(qb)
        alpha = np.minimum(r[5] * np.exp(np.minimum(power, 0.0)), 0.99)
        with np.errstate(divide="ignore"):
            log_floor = np.abs(np.log(alpha * 255.0))
            passes = (power <= 0) & (alpha >= 1 / 255)
            log_t = np.abs(np.log(np.cumprod(1 - np.where(passes, alpha, 0.0), axis=1)
                                  / trc.comp.T_EPS))
        floor = (power <= 8 * _U * m_scale) & (log_floor <= 16 * _U * (m_scale + 1))
        sign = (np.abs(power) <= 8 * _U * m_scale) & (m_scale > 0) & (r[5] > 0)
        out[t] = (floor | sign | (passes & (log_t <= 1e-3))).any(1)
    return out


def _jnp_blend_grad(data, starts, stops, grid_x, tile, gacc, gend, dtype, chunk=64):
    """jax.grad, w.r.t. the packed data, of sum(gacc * accum) + sum(gend *
    tfinal) with accum and tfinal from the JAX package's blend
    (ops/compositing.py::blend_chunk over each tile's range, as its oracle
    rasterize_tiled scans it), in `dtype`: the per-instance rows the
    backward kernels compute from these cotangents."""
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import compositing as jc

    T = starts.shape[0]
    pixf = jnp.asarray(trc.tile_pixels(grid_x, T // grid_x, *tile, "cpu").numpy(), dtype)
    cap = data.shape[1]
    st, sp = jnp.asarray(starts.numpy()), jnp.asarray(stops.numpy())
    steps = -(-int((stops - starts).max()) // chunk)
    gacc, gend = jnp.asarray(gacc.numpy(), dtype), jnp.asarray(gend.numpy(), dtype)

    def loss(d):
        rows = d[:14].T

        def step(carry, j):
            idx = st[:, None] + j * chunk + jnp.arange(chunk)[None]
            ok = idx < sp[:, None]
            r = rows[jnp.clip(idx, 0, cap - 1)][:, None]
            feats = jnp.where(ok[:, None, :, None], r[..., 6:14], 0.0)
            return jc.blend_chunk(carry, pixf, r[..., 0:2], r[..., 2:5], r[..., 5], feats,
                                  ok[:, None], jnp.zeros(idx.shape, jnp.int32)[:, None]), None

        carry, _ = jax.lax.scan(jax.checkpoint(step),
                                jc.init_carry((T, pixf.shape[1]), 8, dtype), jnp.arange(steps))
        tfinal = jnp.where(carry.t_final >= jc.T_SENTINEL, carry.cum, carry.t_final)
        return (carry.accum * gacc).sum() + (tfinal * gend[..., 0]).sum()

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(data.numpy(), dtype)), np.float64)


def hard_frame_case(kind, zero_undecided=True):
    """One hard frame at 16x16 with seeded cotangents, zero on its undecided
    pixels unless told otherwise: JAX's two float32 evaluations, the
    float64 reference, the port's plain version and twin, and the pairs the
    port and JAX decide differently on the other pixels."""
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from torch_parity import jax_kernel_dot, jax_tiles

    tile = (16, 16)
    data, starts, stops, gx = _hard_frame(kind, tile)
    T = starts.shape[0]
    with jax_tiles(*tile), jax_kernel_dot("split"):
        g = jrp.G_CHUNK
        padded = torch.zeros((16, -(-data.shape[1] // g) * g + g))
        padded[:, :data.shape[1]] = data
        data = padded
        kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1])
        accum, tfinal, _ = trc.composite_tiles_plain(
            data, torch.zeros(data.shape[1], dtype=torch.int32), starts, stops, **kw)
        undecided = torch.from_numpy(_undecided_pixels(data, starts, stops, gx, tile))
        gacc, gend = _numpy_cotangents(T, tile[0] * tile[1])
        if zero_undecided:
            gacc[undecided], gend[undecided] = 0.0, 0.0
        acdot = (accum[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
        pallas = np.asarray(jrp._backward_pallas(
            *(jnp.asarray(a.numpy()) for a in (data, starts, stops)),
            jnp.arange(T, dtype=jnp.int32),
            *(jnp.asarray(a.numpy()) for a in (gacc, acdot, gend, tfinal)),
            num_tiles=T, grid_x=gx, interpret=True), np.float64)
        blend32 = _jnp_blend_grad(data, starts, stops, gx, tile, gacc, gend, jnp.float32)
        with jax.enable_x64(True):
            exact = _jnp_blend_grad(data, starts, stops, gx, tile, gacc, gend, jnp.float64)
    args = (data, starts, stops, gacc, acdot, gend, tfinal)
    port = {"plain": trc.composite_tiles_bwd_plain(*args, **kw).double().numpy(),
            "twin": trc.composite_tiles_bwd_walk(*args, **kw).double().numpy()}
    pix = trc.tile_pixels(gx, T // gx, *tile, "cpu")
    split = 0
    for t in range(T):
        lo, hi = int(starts[t]), int(stops[t])
        r = data[:6, lo:hi].t()
        _, m = trc.comp.chunk_alpha(pix[t], r[None, :, 0:2], r[None, :, 2:5], r[None, :, 5],
                                    torch.ones((1, hi - lo), dtype=torch.bool))
        rj, pj = jnp.asarray(r.numpy()), jnp.asarray(pix[t].numpy())
        dx = rj[None, :, 0] - pj[:, None, 0]
        dy = rj[None, :, 1] - pj[:, None, 1]
        power = -0.5 * (rj[:, 2] * dx * dx + rj[:, 4] * dy * dy) - rj[:, 3] * dx * dy
        alpha = jnp.minimum(rj[:, 5] * jnp.exp(jnp.minimum(power, 0.0)), 0.99)
        m_j = np.asarray((power <= 0.0) & (alpha >= 1 / 255))
        split += int(((m.numpy() != m_j) & ~undecided[t].numpy()[:, None]).sum())
    lo, hi = int(starts[0]), int(stops[-1])
    return dict(kind=kind, lo=lo, hi=hi, exact=exact, jax={"pallas": pallas,
                "blend32": blend32}, port=port, split=split,
                undecided=int(undecided.sum()), pixels=undecided.numel())


@pytest.fixture(scope="module", params=HARD_KINDS)
def hard_case(request):
    return hard_frame_case(request.param)


def hard_frame_errors(case) -> dict:
    """{evaluation: {row group: largest |x - float64 reference|}} over the
    frame's ranges, for JAX's two and the port's two evaluations."""
    lo, hi = case["lo"], case["hi"]
    return {name: {g: float(np.abs(x[rows, lo:hi] - case["exact"][rows, lo:hi]).max())
                   for g, rows in ROWS.items()}
            for name, x in (*case["jax"].items(), *case["port"].items())}


def test_hard_frames_decide_alike_off_the_undecided_pixels(hard_case):
    """The premise of the comparison: with the undecided pixels left out,
    the port's exact test and JAX's decide every pair alike, and a share
    of the pixels and gradient columns is left to compare."""
    assert hard_case["split"] == 0
    assert hard_case["undecided"] < hard_case["pixels"]
    lo, hi = hard_case["lo"], hard_case["hi"]
    assert (hard_case["exact"][:14, lo:hi] != 0).any(0).sum() > 40


@pytest.mark.parametrize("impl", ["plain", "twin"])
def test_port_within_jax_spread_on_hard_frames(hard_case, impl):
    """Per row group, the port's largest error against the float64
    reference is at most HARD_FRAME_RATIO times JAX's own (the larger of its
    TPU kernel's and its float32 blend's)."""
    errs = hard_frame_errors(hard_case)
    lo, hi = hard_case["lo"], hard_case["hi"]
    for g, rows in ROWS.items():
        jax_err = max(errs["pallas"][g], errs["blend32"][g])
        floor = 1e-7 * np.abs(hard_case["exact"][rows, lo:hi]).max()
        assert errs[impl][g] <= HARD_FRAME_RATIO * jax_err + floor, (g, errs)
    assert not hard_case["port"][impl][:, :lo].any() and not hard_case["port"][impl][:, hi:].any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _hold_kernel_to_plain(data, gid, starts, stops, gx, tile, *, tolerance=True, offsets=None,
                          tile0=0):
    """csrc/composite_bwd.cu on the frame, kernel A's accum and tfinal of it
    and seeded O(1) cotangents, on the card: bit-equal to its twin
    composite_tiles_bwd_walk (the same arithmetic and order of sums, so a
    pair the cull drops or a sum the reduction misroutes changes bits), two
    launches bit-equal (no atomics), zero outside every range and, with
    `tolerance`, element by element within BWD_RTOL of the plain version
    plus BWD_ATOL of its row group's largest (the kernel sums the pixels in
    another order). `offsets`: the frame's per-tile subpixel offsets;
    `tile0`: the grid index of the frame's first tile. Returns the kernel's
    dgrad and its inputs."""
    from ex4dgs_tpu_torch.bench_frame import cotangents

    kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1], offsets=offsets, tile0=tile0)
    accum, tfinal, _ = trc.composite_tiles_fwd(data, gid, starts, stops, track_idx=False, **kw)
    gacc, acdot, gend = cotangents(accum)
    args = (data, starts, stops, gacc, acdot, gend, tfinal)
    before = kernels.launches["composite_bwd"]
    got = trc.composite_tiles_bwd(*args, **kw)
    again = trc.composite_tiles_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["composite_bwd"] == before + 2
    assert torch.equal(got, again)
    lo, hi = int(starts[0]), int(stops[-1])
    assert bool(torch.isfinite(got).all())
    assert not got[:, :lo].any() and not got[:, hi:].any() and not got[14:].any()
    twin = trc.composite_tiles_bwd_walk(*args, **kw)
    diff = (got - twin).abs()
    assert torch.equal(got, twin), (diff.max().item(), int((diff > 0).sum()))
    want = trc.composite_tiles_bwd_plain(*args, **kw)
    assert bool(want[:14, lo:hi].any())  # a non-trivial gradient
    if tolerance:
        errs = trc.bwd_errors(got, want, lo, hi)
        assert all(e[1] <= 1.0 for e in errs.values()), errs
    return got, args


@pytest.mark.cuda
@pytest.mark.parametrize("frame, tile", [
    *(pytest.param("scene", t, id=i) for t, i in zip(CARD_TILES, CARD_IDS)),
    pytest.param("bench", (32, 16), id="32x16-bench")])
def test_backward_kernel_at_tile0_on_card(cuda_device, frame, tile):
    """The slab branch: a small make_scene frame's (or the bench frame's)
    tiles from tile0 = grid_x + 1 (not the start of a row) through kernel B
    at that tile0, held as _hold_kernel_to_plain holds it, and bit-equal to
    the whole frame's kernel on the same cotangents in the slab's columns."""
    from test_torch_composite import FRAMES

    data, gid, starts, stops, gx = FRAMES[frame](tile, cuda_device)
    t0 = gx + 1
    assert t0 % gx
    got, args = _hold_kernel_to_plain(data, gid, starts[t0:].contiguous(),
                                      stops[t0:].contiguous(), gx, tile, tile0=t0)
    _, st, sp, gacc, acdot, gend, tfinal = args
    full = [torch.cat([torch.zeros((t0, *a.shape[1:]), device=a.device), a])
            for a in (gacc, acdot, gend, tfinal)]
    whole = trc.composite_tiles_bwd(data, starts, stops, *full, grid_x=gx, tile_x=tile[0],
                                    tile_y=tile[1])
    lo, hi = int(st[0]), int(sp[-1])
    assert torch.equal(got[:, lo:hi], whole[:, lo:hi])


@pytest.mark.cuda
@pytest.mark.parametrize("frame, tile, offsets", [
    *(pytest.param("scene", t, False, id=i) for t, i in zip(CARD_TILES, CARD_IDS)),
    pytest.param("bench", (32, 16), False, id="32x16-bench"),
    pytest.param("bench", (16, 16), False, id="16x16-bench"),
    pytest.param("bench", (32, 16), True, id="32x16-bench_offsets")])
def test_backward_kernel_matches_plain_on_card(cuda_device, frame, tile, offsets):
    """On a small make_scene frame at t = 2.5 (_hold_kernel_to_plain); at
    8x4 and 24x4 a warp's pixels span rows (24x4: a warp wraps). The bench
    frame is the cells' full-width frame at the tiles they launch
    (test_torch_composite._bench_frame), also with bench_frame's subpixel
    offsets."""
    from test_torch_composite import FRAMES, frame_offsets

    data, gid, starts, stops, gx = FRAMES[frame](tile, cuda_device)
    _hold_kernel_to_plain(data, gid, starts, stops, gx, tile,
                          offsets=frame_offsets(offsets, gx, starts.shape[0], tile, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", CARD_TILES, ids=CARD_IDS)
@pytest.mark.parametrize("kind", ["threshold", "singular"])
def test_backward_kernel_on_sweep_frames_on_card(cuda_device, kind, tile):
    """The kernel's own cull and reduction on the cull's near-threshold and
    near-singular sweeps (one copy per tile), where a dropped near-floor
    pair would change its column's bits. On the near-singular sweep the
    plain version differs from itself walked one instance at a time
    (chunk=1) by more than BWD_RTOL/BWD_ATOL (the gradients of splats with
    b^2 -> ac cancel in every order of float32 sums), so there the kernel
    is held to its twin alone."""
    from test_torch_cull import _sweep_frame

    data, _, starts, stops, gx = _sweep_frame(kind, tile, "cuda")
    data, starts, stops = _one_range_per_tile(data, starts, stops)
    gid = torch.arange(data.shape[1], dtype=torch.int32, device=data.device)
    _hold_kernel_to_plain(data, gid, starts, stops, gx, tile, tolerance=kind == "threshold")


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0, "nonfinite"],
                         ids=["0.5px", "1px", "3px", "nonfinite"])
@pytest.mark.parametrize("tile", CARD_TILES, ids=CARD_IDS)
@pytest.mark.parametrize("kind", ["threshold", "singular"])
def test_backward_kernel_on_sweep_frames_with_offsets_on_card(cuda_device, kind, tile, scale):
    """The sweep frames of tests/test_torch_cull.py built around pixels
    moved by subpixel offsets (grid_offsets), through the kernel with the
    same offsets: bit-equal to its twin (a pair the offset-aware cull drops
    changes bits), two launches bit-equal, zero outside the ranges."""
    from test_torch_cull import _sweep_frame, grid_offsets

    off = grid_offsets(tile, scale)
    data, _, starts, stops, gx = _sweep_frame(kind, tile, "cuda", offsets=off)
    data, starts, stops = _one_range_per_tile(data, starts, stops)
    gid = torch.arange(data.shape[1], dtype=torch.int32, device=data.device)
    _hold_kernel_to_plain(data, gid, starts, stops, gx, tile, tolerance=False,
                          offsets=off.to(data.device))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", CARD_TILES, ids=CARD_IDS)
def test_backward_kernel_on_adversarial_frame_on_card(cuda_device, tile):
    """The adversarial frame of tests/test_torch_composite.py: splats across
    warp rows, thin ellipses and opacities on the alpha floor, and an empty
    tile. As on the near-singular sweep, the plain version differs from
    itself walked one instance at a time by more than BWD_RTOL/BWD_ATOL
    here, so the kernel is held to its twin alone."""
    from test_torch_composite import _adversarial_frame

    _hold_kernel_to_plain(*_adversarial_frame(tile, cuda_device), tile, tolerance=False)


if __name__ == "__main__":
    # The hard frames' errors against the float64 reference, as PERF.md reports them.
    import sys

    def largest(a, b, lo, hi):
        return {g: float(np.abs(a[r, lo:hi] - b[r, lo:hi]).max()) for g, r in ROWS.items()}

    for kind in HARD_KINDS:
        raw = hard_frame_case(kind, zero_undecided=False)
        lo, hi = raw["lo"], raw["hi"]
        print(f"{kind}, every pixel's cotangents: port plain - Pallas "
              + "  ".join(f"{g} {v:.3g}" for g, v in
                          largest(raw["port"]["plain"], raw["jax"]["pallas"], lo, hi).items())
              + "; largest |Pallas| " + "  ".join(
                  f"{g} {np.abs(raw['jax']['pallas'][r, lo:hi]).max():.3g}"
                  for g, r in ROWS.items()))
        case = hard_frame_case(kind)
        errs = hard_frame_errors(case)
        gap = largest(case["jax"]["pallas"], case["jax"]["blend32"], lo, hi)
        print(f"{kind}: {case['undecided']} of {case['pixels']} pixels undecided, "
              f"{int((case['exact'][:14, lo:hi] != 0).any(0).sum())} of {hi - lo} columns "
              f"non-zero, {case['split']} pairs decided apart elsewhere")
        for name, e in (*errs.items(), ("pallas - blend32", gap)):
            print(f"  {name:>16}: " + "  ".join(f"{g} {v:.3g}" for g, v in e.items()))
    sys.exit(0)
