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
def jax_tiles(tile_x, tile_y):
    """The JAX package configured for tile_x x tile_y tiles (pair=2 at 16x16,
    its measured setting there), restored afterwards."""
    base = current()
    pair = 2 if tile_x * tile_y <= 256 else 1
    configure(KernelConfig(**{**base.as_dict(), "tile_x": tile_x, "tile_y": tile_y,
                              "pair": pair}))
    try:
        yield
    finally:
        configure(base)


def jax_bin(proj, grid_x, grid_y, capacity, exact_depth_sort=False):
    """The JAX package's bin_gaussians under jit: the same integer results
    as the eager call, without seconds of per-operation compiles."""
    return jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3, 4))(
        proj, grid_x, grid_y, capacity, exact_depth_sort)


def tt(x):
    """numpy or JAX array -> CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(x))


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
