"""The port's whole render slice against the JAX package, and against the
golden render.

`render(..., device="cpu")` of ex4dgs_tpu_torch (temporal query, projection,
SH, binning, packing and the compositing kernel's plain version) is held
against the JAX `render` with its jnp backend, on the same model and camera
carried across with model_from_numpy / RenderCamera.from_numpy. Binning
equals exactly (total, radii) and so do the dominant ids. The images agree to
1e-5 (depth 1e-4, in scene units of 2-4): both blend with the same
sequential chunked product in float32, but XLA fuses the jitted JAX render
and reorders its sums (measured here: <= 4e-6 on color and acc, 1.4e-5 on
depth; eager JAX agrees to 1e-6).

The golden file pins 16x16 tiles; the port renders it through its public
`render_points` at the tolerances of tests/test_golden.py.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu import rendering as jr
from ex4dgs_tpu import synthetic as jsyn
from ex4dgs_tpu_torch import rendering as tr
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models import config as tcfg
from ex4dgs_tpu_torch.models.temporal import PointData
from ex4dgs_tpu_torch.ops.binning import bin_gaussians
from ex4dgs_tpu_torch.ops.projection import tile_grid
from ex4dgs_tpu_torch.ops.rasterize_cuda import rasterize_tiled_cuda
from scenes import make_camera, random_gaussians
from torch_parity import port_camera, port_model

torch.set_num_threads(2)

CAP = 8192
BG = (0.1, 0.2, 0.3)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "render_v1.npz")
FIELDS = ("render", "depth", "opticalflow", "acc")


@pytest.fixture(scope="module")
def scene():
    jm, jc = jsyn.make_scene(n_static=1200, n_dynamic=150, duration=10.0, seed=5,
                             static_capacity=1280, dynamic_capacity=160, opacity=0.5)
    jcam = jsyn.ring_cameras(3, 3.0, 96, 64, far=jc.far)[1]
    return jm, jc, jcam, port_model(jm), tcfg.ModelConfig(**vars(jc)), port_camera(jcam)


@functools.lru_cache(maxsize=None)
def _jax_render(cfg, mode):
    return jax.jit(functools.partial(jr.render, cfg=cfg, mode=mode, backend="jnp",
                                     capacity=CAP))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("t", [0.0, 2.5, 7.0])
def test_render_matches_jax(scene, mode, t):
    jm, jc, jcam, tm, tc, tcam = scene
    want = _jax_render(jc, mode)(jcam, jm, t=jnp.asarray(t, jnp.float32), bg=jnp.asarray(BG))
    got = tr.render(tcam, tm, tc, t=t, bg=BG, mode=mode, capacity=CAP, device="cpu")
    assert int(got.binning_total) == int(want.binning_total) <= CAP
    assert got.static_num == want.static_num
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_array_equal(got.visibility_filter.numpy(),
                                  np.asarray(want.visibility_filter))
    assert float(got.acc.mean()) > (0.005 if mode == 2 else 0.1)  # not all background
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, atol=1e-4 if name == "depth" else 1e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(got.dominent_idxs.numpy(), np.asarray(want.dominent_idxs))


def test_render_without_ids(scene):
    _, _, _, tm, tc, tcam = scene
    a = tr.render(tcam, tm, tc, t=2.5, bg=BG, capacity=CAP, device="cpu")
    b = tr.render(tcam, tm, tc, t=2.5, bg=BG, capacity=CAP, device="cpu", track_idx=False)
    assert bool((b.dominent_idxs == -1).all()) and bool((a.dominent_idxs >= 0).any())
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_golden_render_16x16():
    cam, meta = make_camera(96, 64)
    sc = {k: np.asarray(v) for k, v in random_gaussians(250, seed=11).items()}
    n = sc["means"].shape[0]
    pts = PointData(
        means3d=torch.tensor(sc["means"]),
        rotations=torch.tensor(sc["quats"]),
        scales=torch.exp(torch.tensor(sc["log_scales"])),
        opacity=torch.sigmoid(torch.tensor(sc["opacity_logit"][:, 0])),
        features=torch.tensor(np.concatenate([sc["sh_dc"], sc["sh_rest"]], axis=1)),
        mask=torch.ones(n, dtype=torch.bool), static_num=n)
    tcam = tr.RenderCamera.from_numpy(np.asarray(cam.view), np.asarray(cam.proj),
                                      np.asarray(cam.campos), 96, 64, meta["tan_fovx"],
                                      meta["tan_fovy"], device="cpu")
    cfg = tcfg.ModelConfig(kernel_size=0.1)
    out = tr.render_points(pts, tcam, cfg, bg=BG, near=0.2, far=100.0, capacity=8192,
                           kernel_cfg=KernelConfig(tile_x=16, tile_y=16), device="cpu")
    g = np.load(GOLDEN)
    np.testing.assert_allclose(out.render.numpy(), g["color"], atol=2e-6)
    np.testing.assert_allclose(out.depth.numpy(), g["depth"], atol=2e-4)
    np.testing.assert_allclose(out.acc.numpy(), g["acc"], atol=2e-6)
    # RenderResult carries no final_t: read it from the compositor the
    # render went through, on the render's own projection
    binning = bin_gaussians(out.projected, *tile_grid(96, 64, 16, 16), 8192)
    colors = tr.preprocess_points(pts, tcam, cfg, near=0.2, far=100.0,
                                  kernel_cfg=KernelConfig(tile_x=16, tile_y=16))[1]
    ro = rasterize_tiled_cuda(out.projected, colors, torch.zeros((n, 3)), binning, width=96,
                              height=64, bg=torch.tensor(BG), max_depth=100.0, tile_x=16,
                              tile_y=16)
    np.testing.assert_allclose(ro.final_t.numpy(), g["final_t"], atol=2e-6)
    np.testing.assert_array_equal(ro.color.numpy(), out.render.numpy())
