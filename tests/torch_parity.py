"""Shared inputs for the tests that hold ex4dgs_tpu_torch against ex4dgs_tpu.

Every input is made with numpy from a seed and handed to both packages; JAX
stays on the CPU. `jax_tiles` switches the JAX package's tile shape (a
module-global knob there) for the length of a `with` block; the port takes
the tile shape as an argument.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ex4dgs_tpu.kernel_config import KernelConfig, configure, current
from ex4dgs_tpu.ops import binning as jbin
from ex4dgs_tpu.ops import math3d as jm3
from ex4dgs_tpu.ops import projection as jproj
from ex4dgs_tpu_torch.ops import math3d as tm3
from ex4dgs_tpu_torch.ops import projection as tproj
from scenes import make_camera, random_gaussians

W, H = 96, 64
TILES = [(32, 16), (16, 16)]


@contextlib.contextmanager
def jax_config(**knobs):
    """The JAX package with some kernel_config knobs overridden (module
    globals there), restored afterwards."""
    base = current()
    configure(KernelConfig(**{**base.as_dict(), **knobs}))
    try:
        yield
    finally:
        configure(base)


def jax_tiles(tile_x, tile_y):
    """The JAX package configured for tile_x x tile_y tiles (pair=2 at 16x16,
    its measured setting there), restored afterwards."""
    return jax_config(tile_x=tile_x, tile_y=tile_y, pair=2 if tile_x * tile_y <= 256 else 1)


def jax_kernel_dot(mode):
    """The JAX Pallas kernels' in-kernel dot precision ("split" is the
    strict 2e-5 gradient contract of tests/test_pallas.py)."""
    return jax_config(kernel_dot=mode)


def jax_bin(proj, grid_x, grid_y, capacity, exact_depth_sort=False):
    """The JAX package's bin_gaussians under jit: the same integer results
    as the eager call, without seconds of per-operation compiles."""
    return jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3, 4))(
        proj, grid_x, grid_y, capacity, exact_depth_sort)


def tt(x):
    """numpy or JAX array -> CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(x))


def expansion_slots(order: torch.Tensor) -> torch.Tensor:
    """Binning.slot of a binning without the tight cull, from its Gaussian
    ids alone: a Gaussian's instances lie in distinct tiles, expanded in
    tile order, so the expansion order is the stable sort of the ids, and
    each sorted instance's expansion slot is that sort's inverse."""
    by_gauss = torch.sort(order, stable=True).indices
    slot = torch.empty_like(by_gauss)
    slot[by_gauss] = torch.arange(by_gauss.shape[0])
    return slot.to(torch.int32)


def port_binning(bj):
    """The JAX package's Binning (no tight cull) as the port's: its arrays,
    and the port's own `slot` (expansion_slots)."""
    from ex4dgs_tpu_torch.ops.binning import Binning

    fields = {f: tt(getattr(bj, f)) for f in Binning._fields if f != "slot"}
    return Binning(**fields, slot=expansion_slots(fields["order"]))


def as_np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def model_arrays(jax_model):
    """A JAX GaussianModel as the keyword arguments of the port's
    model_from_numpy (numpy arrays, name for name)."""
    return dict(
        params={k: np.asarray(v) for k, v in jax_model.params.items()},
        static_mask=np.asarray(jax_model.static_mask),
        dynamic_mask=np.asarray(jax_model.dynamic_mask),
        stats={k: np.asarray(v) for k, v in jax_model.stats.items()},
        active_sh_degree=np.asarray(jax_model.active_sh_degree),
        duration=np.asarray(jax_model.duration),
        keyframe_num=np.asarray(jax_model.keyframe_num),
    )


def port_model(jax_model):
    from ex4dgs_tpu_torch.models.state import model_from_numpy

    return model_from_numpy(**model_arrays(jax_model), device="cpu")


def port_camera(jax_cam):
    from ex4dgs_tpu_torch.rendering import RenderCamera

    return RenderCamera.from_numpy(
        np.asarray(jax_cam.view), np.asarray(jax_cam.proj), np.asarray(jax_cam.campos),
        jax_cam.width, jax_cam.height, np.asarray(jax_cam.tan_fovx),
        np.asarray(jax_cam.tan_fovy), device="cpu")


def projected_scene(n=300, seed=0, tile=(32, 16), flow_scale=0.1):
    """One random scene of tests/scenes.py projected by both packages.

    Returns (jax dict, torch dict) with keys proj, colors, flow and the grid
    (gx, gy). Call inside `jax_tiles(*tile)`."""
    cam, meta = make_camera(W, H)
    sc = random_gaussians(n, seed=seed)
    tan_x, tan_y = np.float32(meta["tan_fovx"]), np.float32(meta["tan_fovy"])
    rng = np.random.default_rng(seed + 7)
    flow = (rng.normal(size=(n, 3)) * flow_scale).astype(np.float32)
    sh = np.concatenate([np.asarray(sc["sh_dc"]), np.asarray(sc["sh_rest"])], axis=1)
    scales = np.exp(np.asarray(sc["log_scales"]))
    opac = np.asarray(jax.nn.sigmoid(sc["opacity_logit"][:, 0]))
    kw = dict(width=W, height=H, kernel_size=0.1, min_depth=0.2, max_depth=100.0)

    cov_j = jproj.compute_cov3d(jnp.asarray(scales), sc["quats"])
    proj_j = jproj.project_gaussians(sc["means"], cov_j, jnp.asarray(opac), cam,
                                     tan_fovx=jnp.asarray(tan_x), tan_fovy=jnp.asarray(tan_y),
                                     **kw)
    colors_j = jm3.sh_to_rgb(3, jnp.asarray(sh), sc["means"], cam.campos)

    cam_t = tproj.CameraArrays(view=tt(cam.view), proj=tt(cam.proj), campos=tt(cam.campos))
    means_t = tt(sc["means"])
    cov_t = tproj.compute_cov3d(tt(scales), tt(sc["quats"]))
    proj_t = tproj.project_gaussians(means_t, cov_t, tt(opac), cam_t, tan_fovx=tt(tan_x),
                                     tan_fovy=tt(tan_y), tile_x=tile[0], tile_y=tile[1], **kw)
    colors_t = tm3.sh_to_rgb(3, tt(sh), means_t, cam_t.campos)
    gx, gy = tproj.tile_grid(W, H, *tile)
    return (dict(proj=proj_j, colors=colors_j, flow=jnp.asarray(flow), gx=gx, gy=gy),
            dict(proj=proj_t, colors=colors_t, flow=tt(flow), gx=gx, gy=gy))


def backward_inputs(j, capacity, tile, seed=11, scale=1e-3, offsets=None):
    """Inputs of the backward compositing step for both packages, from a
    projected_scene `j` (call inside `jax_tiles(*tile)`): each package's
    packed buffer, the tile ranges, and seeded cotangents (gacc [T, P, 8]
    and gend [T, P, 1], normal with std `scale`) with acdot formed from the
    forward's accum as the autograd function forms it, and the forward's
    tfinal (composited with the per-tile subpixel `offsets`, a numpy
    [T, P, 2], when given). Returns (jax dict, torch dict) with keys data,
    starts, stops, gacc, acdot, gend, tfinal, grid_x and offsets."""
    from ex4dgs_tpu.ops import rasterize_pallas as jrp
    from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
    from ex4dgs_tpu_torch.ops.binning import Binning
    from ex4dgs_tpu_torch.ops.projection import Projected

    bj = jax_bin(j["proj"], j["gx"], j["gy"], capacity)
    data_j, _ = jrp.pack_sorted(j["proj"], j["colors"], j["flow"], bj)
    proj = Projected(*(tt(a) for a in j["proj"]))
    b = port_binning(bj)
    data_t, gid_t = trc.pack_sorted(proj, tt(j["colors"]), tt(j["flow"]), b)
    off_t = None if offsets is None else tt(offsets)
    accum, tfinal, _ = trc.composite_tiles_plain(
        data_t, gid_t, b.tile_start, b.tile_stop, grid_x=j["gx"], tile_x=tile[0],
        tile_y=tile[1], track_idx=False, offsets=off_t)
    T, npix = accum.shape[:2]
    rng = np.random.default_rng(seed)
    gacc = (rng.normal(size=(T, npix, 8)) * scale).astype(np.float32)
    gend = (rng.normal(size=(T, npix, 1)) * scale).astype(np.float32)
    acdot = (accum[..., 0:3].numpy() * gacc[..., 0:3]).sum(-1, keepdims=True)
    arrays = dict(gacc=gacc, acdot=acdot.astype(np.float32), gend=gend,
                  tfinal=tfinal.numpy())
    out_j = dict(data=data_j, starts=bj.tile_start, stops=bj.tile_stop, grid_x=j["gx"],
                 offsets=None if offsets is None else jnp.asarray(offsets),
                 **{k: jnp.asarray(v) for k, v in arrays.items()})
    out_t = dict(data=data_t.detach(), starts=b.tile_start, stops=b.tile_stop,
                 grid_x=j["gx"], offsets=off_t, **{k: tt(v) for k, v in arrays.items()})
    return out_j, out_t


def port_pull(jax_model):
    """The port's HostModel of a JAX model's weights (carried across with
    port_model, fresh optimizer state)."""
    from ex4dgs_tpu_torch.models.density import pull
    from ex4dgs_tpu_torch.models.optimizer import init_state

    m = port_model(jax_model)
    return pull(m, init_state(m.params, device="cpu"))


def as_jax_host(hm):
    """A copy of the port's HostModel as the JAX package's HostModel."""
    import copy

    from ex4dgs_tpu.models.density import HostModel

    return HostModel(**copy.deepcopy(vars(hm)))


def assert_hosts_equal(port, jax_hm, what=""):
    """Every array (dtype and value) and scalar of the port's HostModel and
    the JAX package's equal, exactly."""
    from ex4dgs_tpu.models.density import HostModel as JHostModel
    from ex4dgs_tpu_torch.models.density import HostModel

    assert isinstance(port, HostModel) and isinstance(jax_hm, JHostModel)
    for group in ("params", "stats", "mu", "nu"):
        p, j = getattr(port, group), getattr(jax_hm, group)
        assert sorted(p) == sorted(j), (what, group)
        for k in j:
            assert p[k].dtype == j[k].dtype, (what, group, k)
            np.testing.assert_array_equal(p[k], j[k], err_msg=f"{what} {group} {k}")
    for k in ("step", "active_sh_degree", "duration", "keyframe_num"):
        assert getattr(port, k) == getattr(jax_hm, k), (what, k)
