"""ex4dgs_tpu_torch's tile-sharded compositing against the JAX package's
(tests/test_parallel.py on the port), on the CPU.

- Slab binning (`bin_gaussians(row0=, rows=, total_tiles=)`) equals JAX's
  array for array at 2, 4 and 8 slabs of a frame whose tile grid has 8 rows
  (160x128 at 32x16), with the tight cull off and on, and on the exact
  sort.
- The kernels' plain versions at a first tile `tile0` that is not a
  multiple of grid_x (slabs always start a row, so an x-origin mix-up
  shows only there) against the TPU kernels `_forward_pallas` /
  `_backward_pallas(tids=t0 + arange, interpret=True)` under strict dots,
  at tests/test_pallas.py's tolerances (tests/test_torch_composite.py's and
  tests/test_torch_backward.py's), and bit-equal to the whole frame's rows;
  the backward's twin too.
- The slabs run in turn in one process (`composite_projected_slabs`) and
  under gloo ranks (`composite_projected_sharded`) give the unsharded
  frame bit for bit, and JAX's shard_map frame within
  test_tile_sharded_composite_matches_full's tolerances.

Ranks are spawned processes (`spawn_ranks`): gloo over a file store in the
test's tmp_path, a timeout on every collective, a hard limit on the join
and the ranks killed on failure, so a hung collective fails its test. The
JAX package is imported inside the tests that use it: a spawned rank
imports this module and needs only the port.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parallel.py
"""
import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import synthetic
from ex4dgs_tpu_torch.models.temporal import point_data_at_t
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
from ex4dgs_tpu_torch.ops.binning import bin_gaussians
from ex4dgs_tpu_torch.rendering import (composite_projected, composite_projected_sharded,
                                        composite_projected_slabs, preprocess_points)

torch.set_num_threads(2)

IMAGE_FIELDS = ("render", "depth", "opticalflow", "acc", "dominent_idxs")
JOIN_S = 120  # a spawned job's hard limit
CAP = 65536


# -- spawned ranks ------------------------------------------------------------

def _rank_entry(module, name, rank, world, out_dir, join, args):
    """A spawned rank: join the gloo job of `world` ranks over the file
    store out_dir/pg_init (unless `join` is False: the function joins),
    run module.name(rank, world, *args), save its result as rank<r>.pt (or
    the traceback as rank<r>.err)."""
    import importlib

    import torch.distributed as dist

    torch.set_num_threads(1)
    from ex4dgs_tpu_torch.runtime.distributed import initialize

    try:
        if join:
            initialize(f"file://{out_dir}/pg_init", world, rank, device="cpu", timeout=60)
        fn = getattr(importlib.import_module(module), name)
        torch.save(fn(rank, world, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, tmp_path, *args, limit: float = JOIN_S,
                join: bool = True) -> list:
    """fn(rank, world, *args) on `world` spawned gloo ranks; their results
    in rank order. Fails (and kills every rank) past `limit` seconds or if
    a rank fails. With join=False fn joins the job itself, over the file
    store `store_url(tmp_path, fn, world)`."""
    out_dir = _out_dir(tmp_path, fn, world)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn.__module__, fn.__name__, r, world, out_dir, join, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        errs = {r: open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(world)
                if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))}
        assert not hung, f"ranks {hung} still running after {limit} s; errors: {errs}"
        assert not errs and all(p.exitcode == 0 for p in procs), errs or [
            p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _out_dir(tmp_path, fn, world) -> str:
    return str(tmp_path / f"ranks_{fn.__name__}_{world}")


def store_url(tmp_path, fn, world) -> str:
    """The file store a join=False job of spawn_ranks(fn, world, tmp_path)
    joins over."""
    return f"file://{_out_dir(tmp_path, fn, world)}/pg_init"


# -- the frame ----------------------------------------------------------------

def _frame():
    """A port scene projected at 160x128 (5 x 8 tiles of 32x16)."""
    model, cfg = synthetic.make_scene(n_static=600, n_dynamic=40, seed=1, device="cpu")
    cam = synthetic.ring_cameras(1, 3.0, 160, 128, far=cfg.far, device="cpu")[0]
    pts = point_data_at_t(model, cfg, 1.0)
    proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far)
    flow = torch.from_numpy(np.random.default_rng(3).normal(size=(pts.means3d.shape[0], 3))
                            .astype(np.float32) * 0.1)
    return proj, colors, flow, cam, cfg.far


BG = torch.tensor([0.2, 0.1, 0.4])


def _sharded_rank(rank, world):
    """One rank of a gloo job: composite_projected_sharded over the world."""
    proj, colors, flow, cam, far = _frame()
    out = composite_projected_sharded(proj, colors, flow, cam, bg=BG, far=far, capacity=CAP,
                                      track_idx=True)
    return {k: getattr(out, k) for k in (*IMAGE_FIELDS, "binning_total")}


# -- slab binning ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_frame():
    """tests/torch_parity.py's random scene projected by both packages at
    160x128 (8 tile rows at 32x16)."""
    import torch_parity

    old = torch_parity.W, torch_parity.H
    torch_parity.W, torch_parity.H = 160, 128
    try:
        with torch_parity.jax_tiles(32, 16):
            return torch_parity.projected_scene(n=300, seed=0)
    finally:
        torch_parity.W, torch_parity.H = old


BIN_CASES = [(slabs, tight, False) for slabs in (2, 4, 8) for tight in (False, True)]


@pytest.mark.parametrize("slabs,tight,exact", BIN_CASES + [(4, False, True)],
                         ids=[f"{s}-{'cull' if t else 'nocull'}" for s, t, _ in BIN_CASES]
                         + ["4-exact"])
def test_slab_binning_matches_jax(jax_frame, slabs, tight, exact):
    import jax

    from ex4dgs_tpu.ops import binning as jbin
    from torch_parity import jax_config

    j, t = jax_frame
    gx, gy = j["gx"], j["gy"]
    assert gy >= 8
    rows = -(-gy // slabs)
    cap = CAP // slabs
    with jax_config(tight_cull=tight):
        fn = jax.jit(lambda p, r0: jbin.bin_gaussians(
            p, gx, gy, cap, exact_depth_sort=exact, row0=r0, rows=rows, total_tiles=gx * gy))
        for r in range(slabs):
            want = fn(j["proj"], r * rows)
            got = bin_gaussians(t["proj"], gx, gy, cap, exact_depth_sort=exact, tight_cull=tight,
                                row0=r * rows, rows=rows, total_tiles=gx * gy)
            for name in ("order", "tile_id", "tile_start", "tile_stop", "total", "cum",
                         "counts"):
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)),
                                              err_msg=f"slab {r} {name}")
    # the slabs partition the frame's instances (the cull moves none across)
    whole = bin_gaussians(t["proj"], gx, gy, CAP)
    totals = [int(bin_gaussians(t["proj"], gx, gy, cap, row0=r * rows, rows=rows).total)
              for r in range(slabs)]
    assert sum(totals) == int(whole.total)


def test_slab_binning_orders_like_the_whole_frame(jax_frame):
    """Each slab's tiles hold the whole frame's instances in its order:
    the packed key's depth bits come from total_tiles. The frame's depths
    are set to 16 values 4 ulp apart in one 64-ulp bucket, decreasing with
    the Gaussian index: the whole grid's key (40 tiles, 25 depth bits)
    ties them all, so they blend in index order, and a key quantised with
    a slab's own tile count (10 tiles, 27 depth bits) sorts them apart."""
    _, t = jax_frame
    gx, gy = t["gx"], t["gy"]
    n = t["proj"].depth.shape[0]
    base = torch.tensor(5.0).view(torch.int32) & ~63
    bits = base + 4 * (15 - torch.arange(n, dtype=torch.int32) % 16)
    proj = t["proj"]._replace(depth=bits.view(torch.float32))
    t = {**t, "proj": proj}
    whole = bin_gaussians(t["proj"], gx, gy, CAP)
    differs = False
    for rows, row0 in ((2, 0), (2, 6), (4, 4)):
        for key_tiles, same in ((gx * gy, True), (rows * gx, False)):
            b = bin_gaussians(t["proj"], gx, gy, CAP, row0=row0, rows=rows,
                              total_tiles=key_tiles)
            t0 = row0 * gx
            runs = [(b.order[b.tile_start[i]:b.tile_stop[i]],
                     whole.order[whole.tile_start[t0 + i]:whole.tile_stop[t0 + i]])
                    for i in range(rows * gx)]
            equal = all(torch.equal(a, w) for a, w in runs)
            if same:
                assert equal, (rows, row0)
            differs |= not equal
    assert differs  # the hazard is real on this frame


# -- the plain kernels at tile0 != 0 ---------------------------------------------

TILE0 = [((32, 16), 4, 6), ((16, 16), 7, 9)]  # (tile, tile0, tiles): tile0 % grid_x != 0


@pytest.fixture(scope="module", params=TILE0, ids=["32x16", "16x16"])
def tile0_case(request):
    """A slice of tiles [tile0, tile0 + n) of tests/torch_parity.py's frame
    (96x64) through the TPU kernels with tids = tile0 + arange (interpret
    mode, strict dots), and the port's inputs for the whole frame."""
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from torch_parity import backward_inputs, jax_kernel_dot, jax_tiles, projected_scene

    tile, t0, n = request.param
    s = slice(t0, t0 + n)
    with jax_tiles(*tile), jax_kernel_dot("split"):
        j, _ = projected_scene(n=300, seed=0, tile=tile)
        ij, it = backward_inputs(j, CAP, tile)
        assert t0 % ij["grid_x"] and t0 + n <= it["starts"].shape[0]
        tids = t0 + jnp.arange(n, dtype=jnp.int32)
        fwd = jrp._forward_pallas(ij["data"], ij["starts"][s], ij["stops"][s], tids,
                                  num_tiles=n, grid_x=ij["grid_x"], interpret=True,
                                  track_idx=True)
        bwd = jrp._backward_pallas(ij["data"], ij["starts"][s], ij["stops"][s], tids,
                                   ij["gacc"][s], ij["acdot"][s], ij["gend"][s],
                                   ij["tfinal"][s], num_tiles=n, grid_x=ij["grid_x"],
                                   interpret=True)
        _, gid = trc.pack_sorted(*_port_pack_args(j))
    return dict(tile=tile, t0=t0, s=s, fwd=[np.asarray(a) for a in fwd], bwd=np.asarray(bwd),
                inputs=it, gid=gid)


def _port_pack_args(j):
    from ex4dgs_tpu_torch.ops.projection import Projected
    from torch_parity import jax_bin, port_binning, tt

    b = port_binning(jax_bin(j["proj"], j["gx"], j["gy"], CAP))
    return Projected(*(tt(a) for a in j["proj"])), tt(j["colors"]), tt(j["flow"]), b


def _normalised(accum):
    acc = accum[..., 7]
    denom = np.where(acc > 0, acc, 1.0)
    return (np.where(acc > 0, accum[..., 3] / denom, 100.0),
            np.where(acc[..., None] > 0, accum[..., 4:7] / denom[..., None], 0.0))


def test_plain_forward_at_tile0_matches_pallas(tile0_case):
    c, it = tile0_case, tile0_case["inputs"]
    s, tile = c["s"], c["tile"]
    kw = dict(grid_x=it["grid_x"], tile_x=tile[0], tile_y=tile[1], track_idx=True)
    got = trc.composite_tiles_plain(it["data"], c["gid"], it["starts"][s], it["stops"][s],
                                    tile0=c["t0"], **kw)
    accum, tfinal, bestidx = (a.numpy() for a in got)
    accum_j, tfinal_j, bestidx_j = c["fwd"]
    assert (tfinal < 1).mean() > 0.1  # a non-trivial slice
    np.testing.assert_allclose(accum, accum_j, atol=3e-5, rtol=0)
    np.testing.assert_allclose(tfinal, tfinal_j, atol=3e-5, rtol=0)
    (d, f), (d_j, f_j) = _normalised(accum), _normalised(accum_j)
    np.testing.assert_allclose(d, d_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(f, f_j, atol=1e-4, rtol=0)
    assert (bestidx == bestidx_j).mean() > 0.995
    # the whole frame's rows, bit for bit; at tile0 = 0 the pixels differ
    whole = trc.composite_tiles_plain(it["data"], c["gid"], it["starts"], it["stops"], **kw)
    for a, w in zip(got, whole):
        assert torch.equal(a, w[s])
    wrong = trc.composite_tiles_plain(it["data"], c["gid"], it["starts"][s], it["stops"][s],
                                      **kw)
    assert not torch.equal(wrong[0], got[0])


@pytest.mark.parametrize("fn", ["plain", "twin"])
def test_plain_backward_at_tile0_matches_pallas(tile0_case, fn):
    c, it = tile0_case, tile0_case["inputs"]
    s, tile = c["s"], c["tile"]
    impl = trc.composite_tiles_bwd_plain if fn == "plain" else trc.composite_tiles_bwd_walk
    kw = dict(grid_x=it["grid_x"], tile_x=tile[0], tile_y=tile[1])
    sliced = [it[k][s] for k in ("starts", "stops", "gacc", "acdot", "gend", "tfinal")]
    got = impl(it["data"], *sliced, tile0=c["t0"], **kw)
    lo, hi = int(it["starts"][s][0]), int(it["stops"][s][-1])
    want = c["bwd"]
    assert hi - lo > 50
    for name, rows in trc.BWD_ROWS.items():
        assert np.abs(want[rows, lo:hi]).max() > 1e-4, name
        np.testing.assert_allclose(got.numpy()[rows, lo:hi], want[rows, lo:hi], atol=2e-5,
                                   rtol=0, err_msg=name)
    assert not got[:, :lo].any() and not got[:, hi:].any()
    whole = impl(it["data"], it["starts"], it["stops"], it["gacc"], it["acdot"], it["gend"],
                 it["tfinal"], **kw)
    assert torch.equal(got[:, lo:hi], whole[:, lo:hi])


def test_warp_boxes_at_tile0_are_the_whole_frames():
    gx, T = 5, 40
    whole = trc.warp_boxes(gx, T, 32, 16, "cpu")
    assert torch.equal(trc.warp_boxes(gx, 13, 32, 16, "cpu", tile0=7), whole[7:20])
    pix = trc.tile_pixels(gx, 8, 32, 16, "cpu")
    assert torch.equal(trc.tile_pixels(gx, 0, 32, 16, "cpu", tile0=7, num_tiles=13), pix[7:20])


# -- the slabs' frame -----------------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded():
    proj, colors, flow, cam, far = _frame()
    return composite_projected(proj, colors, flow, cam, bg=BG, far=far, capacity=CAP,
                               track_idx=True)


@pytest.mark.parametrize("slabs", [2, 4, 8])
def test_slabs_in_turn_match_unsharded_and_jax(unsharded, slabs):
    """composite_projected_slabs bit-equal to the unsharded frame; its
    worst-slab total between the true total and slabs times it; against
    JAX's shard_map frame of the same projection at
    test_tile_sharded_composite_matches_full's tolerances."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from ex4dgs_tpu.ops.projection import Projected as JProjected
    from ex4dgs_tpu.rendering import RenderCamera as JCamera
    from ex4dgs_tpu.rendering import composite_projected_sharded as j_sharded

    proj, colors, flow, cam, far = _frame()
    out = composite_projected_slabs(proj, colors, flow, cam, bg=BG, far=far, capacity=CAP,
                                    axis_size=slabs, track_idx=True)
    for name in IMAGE_FIELDS:
        assert torch.equal(getattr(out, name), getattr(unsharded, name)), name
    total = int(unsharded.binning_total)
    assert total <= int(out.binning_total) <= slabs * total

    jp = JProjected(*(jnp.asarray(a.numpy()) for a in proj))
    jcam = JCamera(*(jnp.asarray(a.numpy()) for a in (cam.view, cam.proj, cam.campos)),
                   cam.width, cam.height, jnp.asarray(cam.tan_fovx.numpy()),
                   jnp.asarray(cam.tan_fovy.numpy()))
    mesh = Mesh(np.array(jax.devices()[:slabs]), ("gauss",))
    fn = jax.shard_map(
        lambda p, c, f: j_sharded(p, c, f, jcam, bg=jnp.asarray(BG.numpy()), far=far,
                                  capacity=CAP, axis_name="gauss", axis_size=slabs,
                                  max_per_tile=1024, backend="jnp"),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(), check_vma=False)
    want = jax.jit(fn)(jp, jnp.asarray(colors.numpy()), jnp.asarray(flow.numpy()))
    np.testing.assert_allclose(out.render.numpy(), np.asarray(want.render), atol=1e-6)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(want.depth), atol=1e-5)
    np.testing.assert_allclose(out.acc.numpy(), np.asarray(want.acc), atol=1e-6)
    assert int(out.binning_total) == int(want.binning_total)


def test_sharded_composite_on_gloo_ranks_matches_unsharded(unsharded, tmp_path):
    """composite_projected_sharded on 2 gloo ranks: every rank holds the
    unsharded frame bit for bit and the worst-slab total of the slabs in
    turn."""
    proj, colors, flow, cam, far = _frame()
    turns = composite_projected_slabs(proj, colors, flow, cam, bg=BG, far=far, capacity=CAP,
                                      axis_size=2, track_idx=True)
    for out in spawn_ranks(_sharded_rank, 2, tmp_path):
        for name in IMAGE_FIELDS:
            assert torch.equal(out[name], getattr(unsharded, name)), name
        assert int(out["binning_total"]) == int(turns.binning_total)


def test_sharded_capacity_must_divide():
    proj, colors, flow, cam, far = _frame()
    with pytest.raises(ValueError, match="divide"):
        composite_projected_slabs(proj, colors, flow, cam, bg=BG, far=far, capacity=CAP + 1,
                                  axis_size=2)


@pytest.mark.parametrize("slabs", [2, 4])
def test_composite_slab_oracle_matches_jax_and_the_kernel_path(jax_frame, slabs):
    """ops/rasterize_tiled.py::composite_slab, the torch oracle of one slab,
    against JAX's composite_slab on JAX's slab binning (the oracle
    tolerances of tests/test_torch_composite.py), and its autograd against
    the kernel path's (composite_slab_rank's CompositeTiles and PackSorted,
    plain on the CPU) on the same slab."""
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import binning as jbin
    from ex4dgs_tpu.ops import rasterize_tiled as jrt
    from ex4dgs_tpu_torch.ops.rasterize_tiled import composite_slab
    from ex4dgs_tpu_torch.ops.rasterize_cuda import composite_blocks

    j, t = jax_frame
    gx, gy = j["gx"], j["gy"]
    rows = -(-gy // slabs)
    cap = CAP // slabs
    for r in range(slabs):
        t0 = r * rows * gx
        bj = jax.jit(lambda p: jbin.bin_gaussians(p, gx, gy, cap, row0=r * rows, rows=rows,
                                                  total_tiles=gx * gy))(j["proj"])
        want = jrt.composite_slab(j["proj"], j["colors"], j["flow"], bj, grid_x=gx, t0=t0,
                                  num_local=rows * gx, starts=bj.tile_start,
                                  stops=bj.tile_stop, bg=jnp.asarray(BG.numpy()),
                                  max_depth=100.0, chunk=64, max_per_tile=512)
        b = bin_gaussians(t["proj"], gx, gy, cap, row0=r * rows, rows=rows,
                          total_tiles=gx * gy)
        colors = t["colors"].clone().requires_grad_(True)
        got = composite_slab(t["proj"], colors, t["flow"], b, grid_x=gx, tile0=t0,
                             num_local=rows * gx, bg=BG, max_depth=100.0, chunk=64)
        for name in ("color", "depth", "flow", "acc", "final_t"):
            atol = 1e-5 if name == "depth" else 1e-6
            np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                       np.asarray(getattr(want, name)), atol=atol, rtol=0,
                                       err_msg=f"slab {r} {name}")
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        colors_k = t["colors"].clone().requires_grad_(True)
        blocks = composite_blocks(t["proj"], colors_k, t["flow"], b, grid_x=gx, bg=BG,
                                  max_depth=100.0, tile0=t0)
        for a, k in zip(got[:3], blocks[:3]):
            np.testing.assert_allclose(a.detach().numpy(), k.detach().numpy(), atol=1e-6)
        g = torch.autograd.grad(got.color.square().sum(), colors)[0]
        g_k = torch.autograd.grad(blocks.color.square().sum(), colors_k)[0]
        assert g.abs().max() > 0  # per-Gaussian sums up to ~1e3: held relative to them
        np.testing.assert_allclose(g.numpy(), g_k.numpy(), rtol=1e-5,
                                   atol=1e-7 * g.abs().max().item())
