"""ex4dgs_tpu_torch's dense oracle (`ops/rasterize_dense.py`) and
`ops/projection.py::mark_visible` against the JAX package
(tests/test_rasterizer.py:162-245 on the port).

- the dense oracle against JAX's on the same projected scene: images and
  acc to 3e-5, depth to 1e-4 (tests/test_pallas.py's image and depth
  tolerances), identical ids, with and without subpixel offsets;
- dense against tiled within the port, at tests/test_rasterizer.py's
  tolerances (color, acc and final transmittance 2e-5, depth 1e-4,
  identical ids), at 32x16 and 16x16 tiles;
- a non-empty render, background and far depth where nothing lands;
- gradients of the L1 loss through projection and the dense oracle
  against the tiled oracle (5e-4 of the largest, the JAX test's) and
  against `jax.grad` of JAX's dense oracle (the same bound);
- the flow channel: a cotangent on flow reaches the per-Gaussian flow
  vectors only (opacity's gradient exactly 0), non-negative, and equal to
  JAX's to 1e-5 of its largest;
- mark_visible equal to JAX's on the scene's means and on points placed
  around the frustum's edges.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dense.py
"""
import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch.ops import math3d as tm3
from ex4dgs_tpu_torch.ops import projection as tproj
from ex4dgs_tpu_torch.ops.binning import bin_gaussians
from ex4dgs_tpu_torch.ops.rasterize_dense import rasterize_dense
from ex4dgs_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from torch_parity import H, W, tt

torch.set_num_threads(2)

FAR, NEAR, KERNEL = 100.0, 0.2, 0.1
BG = (0.1, 0.2, 0.3)
PARAMS = ("means", "log_scales", "quats", "opacity_logit", "sh_dc")


@pytest.fixture(scope="module")
def scene():
    """tests/test_rasterizer.py's scene (300 random Gaussians, seed 3) and
    camera, as numpy arrays."""
    from scenes import make_camera, random_gaussians

    cam, meta = make_camera(W, H)
    sc = {k: np.asarray(v) for k, v in random_gaussians(300, seed=3).items()}
    cam_np = {k: np.asarray(getattr(cam, k)) for k in ("view", "proj", "campos")}
    return sc, cam, cam_np, np.float32(meta["tan_fovx"]), np.float32(meta["tan_fovy"])


def _port_project(scene, params, tile=(32, 16)):
    sc, _, cam_np, tan_x, tan_y = scene
    cam = tproj.CameraArrays(**{k: tt(v) for k, v in cam_np.items()})
    cov = tproj.compute_cov3d(torch.exp(params["log_scales"]), params["quats"])
    opac = torch.sigmoid(params["opacity_logit"])[:, 0]
    proj = tproj.project_gaussians(params["means"], cov, opac, cam, width=W, height=H,
                                   tan_fovx=tt(tan_x), tan_fovy=tt(tan_y), kernel_size=KERNEL,
                                   min_depth=NEAR, max_depth=FAR, tile_x=tile[0],
                                   tile_y=tile[1])
    sh = torch.cat([params["sh_dc"], tt(sc["sh_rest"])], dim=1)
    return proj, tm3.sh_to_rgb(3, sh, params["means"], cam.campos)


def _jax_project(scene, params):
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops import math3d as jm3
    from ex4dgs_tpu.ops import projection as jproj

    sc, cam, _, tan_x, tan_y = scene
    cov = jproj.compute_cov3d(jnp.exp(params["log_scales"]), params["quats"])
    opac = jax.nn.sigmoid(params["opacity_logit"])[:, 0]
    proj = jproj.project_gaussians(params["means"], cov, opac, cam, width=W, height=H,
                                   tan_fovx=jnp.asarray(tan_x), tan_fovy=jnp.asarray(tan_y),
                                   kernel_size=KERNEL, min_depth=NEAR, max_depth=FAR)
    sh = jnp.concatenate([params["sh_dc"], jnp.asarray(sc["sh_rest"])], axis=1)
    return proj, jm3.sh_to_rgb(3, sh, params["means"], cam.campos)


def _params(scene, lib):
    sc = scene[0]
    if lib == "torch":
        return {k: tt(sc[k]) for k in PARAMS}
    import jax.numpy as jnp

    return {k: jnp.asarray(sc[k]) for k in PARAMS}


def _offsets():
    return np.random.default_rng(11).uniform(-0.5, 0.5, (H, W, 2)).astype(np.float32)


@pytest.mark.parametrize("subpixel", [False, True], ids=["no_offsets", "offsets"])
def test_dense_matches_jax(scene, subpixel):
    import jax.numpy as jnp

    from ex4dgs_tpu.ops.rasterize_dense import rasterize_dense as jdense

    off = _offsets() if subpixel else None
    proj, colors = _port_project(scene, _params(scene, "torch"))
    jp, jc = _jax_project(scene, _params(scene, "jax"))
    flow = np.random.default_rng(7).normal(size=(300, 3)).astype(np.float32) * 0.1
    got = rasterize_dense(proj, colors, tt(flow), width=W, height=H, bg=torch.tensor(BG),
                          max_depth=FAR, chunk=64,
                          subpixel_offset=None if off is None else tt(off))
    want = jdense(jp, jc, jnp.asarray(flow), width=W, height=H, bg=jnp.asarray(BG),
                  max_depth=FAR, chunk=64, subpixel_offset=None if off is None else
                  jnp.asarray(off))
    for name, tol in (("color", 3e-5), ("acc", 3e-5), ("final_t", 3e-5), ("depth", 1e-4),
                      ("flow", 3e-5)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


@pytest.mark.parametrize("tile", [(32, 16), (16, 16)], ids=["32x16", "16x16"])
def test_dense_tiled_agree(scene, tile):
    proj, colors = _port_project(scene, _params(scene, "torch"), tile)
    flow = torch.zeros((300, 3))
    bg = torch.tensor(BG)
    gx, gy = tproj.tile_grid(W, H, *tile)
    b = bin_gaussians(proj, gx, gy, int(proj.tiles_touched.sum()))
    dense = rasterize_dense(proj, colors, flow, width=W, height=H, bg=bg, max_depth=FAR,
                            tile_x=tile[0], tile_y=tile[1])
    tiled = rasterize_tiled(proj, colors, flow, b, width=W, height=H, bg=bg, max_depth=FAR,
                            chunk=32, tile_x=tile[0], tile_y=tile[1])
    for name, tol in (("color", 2e-5), ("depth", 1e-4), ("acc", 2e-5), ("final_t", 2e-5)):
        np.testing.assert_allclose(getattr(dense, name).numpy(), getattr(tiled, name).numpy(),
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(dense.idx.numpy(), tiled.idx.numpy())


def test_render_nonempty(scene):
    proj, colors = _port_project(scene, _params(scene, "torch"))
    dense = rasterize_dense(proj, colors, torch.zeros((300, 3)), width=W, height=H,
                            bg=torch.tensor(BG), max_depth=FAR)
    acc = dense.acc.numpy()
    assert acc.max() > 0.5 and acc.min() >= 0.0
    assert np.isfinite(dense.color.numpy()).all()
    empty = acc == 0
    assert empty.any()
    np.testing.assert_allclose(dense.depth.numpy()[empty], FAR)
    np.testing.assert_allclose(dense.color.numpy()[empty], np.broadcast_to(BG, (empty.sum(), 3)),
                               atol=1e-7)


def _port_grads(scene, render_fn):
    params = {k: v.clone().requires_grad_() for k, v in _params(scene, "torch").items()}
    proj, colors = _port_project(scene, params)
    img = render_fn(proj, colors).color
    target = torch.linspace(0, 1, img.numel()).reshape(img.shape)
    (img - target).abs().mean().backward()
    return {k: v.grad.numpy() for k, v in params.items()}


def test_grads_dense_vs_tiled_and_jax(scene):
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops.rasterize_dense import rasterize_dense as jdense

    bg = torch.tensor(BG)
    gx, gy = tproj.tile_grid(W, H)

    def dense(proj, colors):
        return rasterize_dense(proj, colors, torch.zeros_like(colors), width=W, height=H,
                               bg=bg, max_depth=FAR)

    def tiled(proj, colors):
        b = bin_gaussians(proj, gx, gy, int(proj.tiles_touched.sum()) + 16)
        return rasterize_tiled(proj, colors, torch.zeros_like(colors), b, width=W, height=H,
                               bg=bg, max_depth=FAR, chunk=64)

    def jloss(params):
        proj, colors = _jax_project(scene, params)
        img = jdense(proj, colors, jnp.zeros_like(colors), width=W, height=H,
                     bg=jnp.asarray(BG), max_depth=FAR).color
        target = jnp.linspace(0, 1, img.size).reshape(img.shape)
        return jnp.abs(img - target).mean()

    g_dense = _port_grads(scene, dense)
    g_tiled = _port_grads(scene, tiled)
    g_jax = jax.grad(jloss)(_params(scene, "jax"))
    for k in PARAMS:
        gd = g_dense[k]
        assert np.isfinite(gd).all(), k
        scale = max(np.abs(gd).max(), 1e-8)
        np.testing.assert_allclose(gd, g_tiled[k], atol=5e-4 * scale + 1e-8, err_msg=k)
        np.testing.assert_allclose(gd, np.asarray(g_jax[k]), atol=5e-4 * scale + 1e-8,
                                   err_msg=k)
    assert np.abs(g_dense["means"]).max() > 0


def test_flow_gradient_channel(scene):
    """A cotangent of ones on the flow output lands on the per-Gaussian flow
    vectors as sum_pix w/acc and nowhere else (JAX's hook semantics)."""
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.ops.rasterize_tiled import rasterize_tiled as jtiled
    from torch_parity import jax_bin

    params = _params(scene, "torch")
    opac_logit = params["opacity_logit"].clone().requires_grad_()
    proj, colors = _port_project(scene, {**params, "opacity_logit": opac_logit})
    gx, gy = tproj.tile_grid(W, H)
    b = bin_gaussians(proj, gx, gy, int(proj.tiles_touched.sum()))
    flow0 = torch.zeros((300, 3), requires_grad=True)
    out = rasterize_tiled(proj, colors, flow0, b, width=W, height=H, bg=torch.tensor(BG),
                          max_depth=FAR, chunk=64)
    d_flow, d_opac = torch.autograd.grad(out.flow, (flow0, opac_logit),
                                         grad_outputs=torch.ones((H, W, 3)),
                                         allow_unused=True)
    assert d_flow.max() > 0 and (d_flow >= -1e-6).all()
    assert d_opac is None or float(d_opac.abs().max()) == 0.0

    jparams = _params(scene, "jax")
    jp, _ = _jax_project(scene, jparams)
    bj = jax_bin(jp, gx, gy, int(np.asarray(jp.tiles_touched).sum()))

    def flow_out(flowvec, opacity_logit):
        p2, c2 = _jax_project(scene, {**jparams, "opacity_logit": opacity_logit})
        return jtiled(p2, c2, flowvec, bj, width=W, height=H, bg=jnp.asarray(BG),
                      max_depth=FAR, chunk=64).flow

    _, vjp = jax.vjp(flow_out, jnp.zeros((300, 3)), jparams["opacity_logit"])
    jd_flow, _ = vjp(jnp.ones((H, W, 3)))
    jd_flow = np.asarray(jd_flow)
    np.testing.assert_allclose(d_flow.numpy(), jd_flow, atol=1e-5 * np.abs(jd_flow).max())


def test_mark_visible_matches_jax(scene):
    import jax.numpy as jnp

    from ex4dgs_tpu.ops.projection import mark_visible as jmark

    sc, cam, cam_np, _, _ = scene
    tcam = tproj.CameraArrays(**{k: tt(v) for k, v in cam_np.items()})
    rng = np.random.default_rng(4)
    # the scene's means, and points spread wide around the frustum's edges
    # and its near/far planes
    edge = rng.uniform(-40, 40, (4000, 3)).astype(np.float32)
    for pts in (sc["means"], edge):
        for near, far in ((0.2, 100.0), (2.0, 8.0)):
            got = tproj.mark_visible(tt(pts), tcam, near, far).numpy()
            want = np.asarray(jmark(jnp.asarray(pts), cam, near, far))
            np.testing.assert_array_equal(got, want)
            assert got.dtype == bool
    got = tproj.mark_visible(tt(edge), tcam).numpy()
    assert 0 < got.sum() < len(edge)
