"""ex4dgs_tpu_torch projection and binning against the JAX package.

Binning is a function of the integer tile rectangles, so `rect_min`,
`rect_max`, `tiles_touched` and `valid` must be equal, and so must every
binning output (`order`, `tile_id`, `tile_start`, `tile_stop`, `total`,
`cum`, `counts`): both sides sort the same integer keys stably. The float
outputs of the projection agree to 1e-5 relative (float32 elementwise math in
the same operation order; the residue is libm sqrt/log/exp rounding).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu.ops import projection as jp
from ex4dgs_tpu_torch.ops import binning as tbin
from ex4dgs_tpu_torch.ops.projection import Projected
from torch_parity import TILES, as_np, jax_bin, jax_tiles, projected_scene, tt

torch.set_num_threads(2)

SEEDS = (0, 3)
# 512 is below the scene's instance count: a forced overflow
CAPACITIES = (8192, 512)


@pytest.fixture(scope="module", params=TILES, ids=["32x16", "16x16"])
def tile_case(request):
    """Everything the JAX side computes at one tile shape, under one switch
    of its tile configuration (the switch clears JAX's compile caches)."""
    tile = request.param
    with jax_tiles(*tile):
        scenes = {s: projected_scene(n=400, seed=s, tile=tile) for s in SEEDS}
        binned = {
            (cap, exact): jax_bin(scenes[0][0]["proj"], scenes[0][0]["gx"],
                                  scenes[0][0]["gy"], cap, exact_depth_sort=exact)
            for cap, exact in itertools.product(CAPACITIES, (False, True))}
    return scenes, binned


@pytest.mark.parametrize("seed", SEEDS)
def test_project_gaussians(tile_case, seed):
    j, t = tile_case[0][seed]
    pj, pt = j["proj"], t["proj"]
    assert int(np.asarray(pj.tiles_touched).sum()) > 400  # a non-trivial scene
    for name in ("rect_min", "rect_max", "tiles_touched", "valid", "radius"):
        np.testing.assert_array_equal(as_np(getattr(pt, name)), np.asarray(getattr(pj, name)),
                                      err_msg=name)
    valid = np.asarray(pj.valid)
    for name in ("xy", "depth", "conic", "opacity"):
        np.testing.assert_allclose(as_np(getattr(pt, name))[valid],
                                   np.asarray(getattr(pj, name))[valid],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(as_np(t["colors"]), np.asarray(j["colors"]), atol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_bin_gaussians_equal(tile_case, exact, capacity):
    """The port bins the JAX projection itself, so only binning is under
    test. In the overflow case both sides drop instances from the back of
    the prefix order alike."""
    j, _ = tile_case[0][0]
    bj = tile_case[1][(capacity, exact)]
    bt = tbin.bin_gaussians(Projected(*(tt(a) for a in j["proj"])), j["gx"], j["gy"],
                            capacity, exact_depth_sort=exact)
    total = int(np.asarray(bj.total))
    assert (total > capacity) == (capacity == min(CAPACITIES)), total
    for name in ("order", "tile_id", "tile_start", "tile_stop", "total", "cum", "counts"):
        got, want = as_np(getattr(bt, name)), np.asarray(getattr(bj, name))
        assert got.dtype == np.int32, (name, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("grid, order", [((1, 1), [1, 0]), ((43, 64), [0, 1])])
def test_packed_key_depth_bits_follow_tile_count(grid, order):
    """DEPTH_BITS = 31 - bit_length(num_tiles). Two splats in tile 0 whose
    depth bit patterns differ only in bit 1: one tile keeps 30 depth bits and
    sorts them by depth; 43x64 tiles keep 19, so they tie and stay in
    Gaussian order. Both packages agree."""
    depth = np.array([0x40A00003, 0x40A00001], np.int32).view(np.float32)
    P = 2
    proj = Projected(
        xy=torch.zeros((P, 2)), depth=torch.tensor(depth), conic=torch.zeros((P, 3)),
        opacity=torch.ones(P), radius=torch.ones(P, dtype=torch.int32),
        rect_min=torch.zeros((P, 2), dtype=torch.int32),
        rect_max=torch.ones((P, 2), dtype=torch.int32),
        tiles_touched=torch.ones(P, dtype=torch.int32), valid=torch.ones(P, dtype=torch.bool))
    bt = tbin.bin_gaussians(proj, *grid, 8)
    bj = jax_bin(jp.Projected(*(jnp.asarray(as_np(a)) for a in proj)), *grid, 8)
    assert as_np(bt.order)[:2].tolist() == order
    np.testing.assert_array_equal(as_np(bt.order), np.asarray(bj.order))
    # the exact sort orders by float depth at any grid size
    bt = tbin.bin_gaussians(proj, *grid, 8, exact_depth_sort=True)
    assert as_np(bt.order)[:2].tolist() == [1, 0]
