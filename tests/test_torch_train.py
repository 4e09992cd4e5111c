"""ex4dgs_tpu_torch's training step against the JAX package's.

The scenes are tests/test_train_step.py's (64x48, 200 static points,
capacity 8192; with and without 16 dynamic points), carried across with
torch_parity.port_model. Both packages take the same seeded ground truth.

- Gradients of the math leaves: point_data_at_t -> preprocess_points against
  jax.grad, for static and dynamic points under the cube, pchip and linear
  interpolators with slerp, and for mean2d_offset, with seeded anisotropic
  scales and rotations: atol 5e-6 times the leaf's largest gradient (at
  least 1), float32 rounding of the terms that sum to it (slerp's arccos
  amplifies it: measured up to 3e-6 on motion_rotation).
- `_loss_and_aux`: the loss and its gradients w.r.t. every param,
  mean2d_offset and flow_dirs, against jax.value_and_grad of the JAX one.
- One whole `train_step`: params, moments and step, every stat, loss, ll1,
  psnr, visibility, binning_total and nan_flag. Integers and masks exactly;
  floats at atol 1e-6 (params, stats) and 1e-7 (moments; they are
  gradients of order 1e-3 and below).
- The port's own versions of tests/test_train_step.py's checks: the loss
  falls by 30% in 25 steps, and an overflowing step changes nothing.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_train_step as jts
from ex4dgs_tpu import rendering as jr
from ex4dgs_tpu.models import temporal as jtemp
from ex4dgs_tpu.models.config import ModelConfig as JModelConfig
from ex4dgs_tpu.models.config import OptimizationConfig as JOpt
from ex4dgs_tpu.models.optimizer import init_state as jinit
from ex4dgs_tpu.models.state import empty_model
from ex4dgs_tpu.train import step as jstep
from ex4dgs_tpu_torch import rendering as tr
from ex4dgs_tpu_torch.models import temporal as ttemp
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.optimizer import init_state
from ex4dgs_tpu_torch.train import step as tstep
from torch_parity import port_camera, port_model

torch.set_num_threads(2)

W, H = jts.W, jts.H
CAP = 8192


def _with_dynamic(cfg, model, nd=16, dyn_cap=64):
    """tests/test_train_step.py::test_train_step_with_dynamic_points's model:
    nd active dynamic splats beside the static cloud."""
    kf = model.keyframe_capacity
    base = empty_model(cfg, model.static_capacity, dyn_cap, kf, duration=5)
    p = dict(base.params)
    for k in model.params:
        if not k.startswith("motion_"):
            p[k] = model.params[k]
    rng = np.random.default_rng(1)
    p["motion_xyz"] = p["motion_xyz"].at[:nd].set(
        jnp.asarray(rng.normal(size=(nd, kf, 3)).astype(np.float32) * 0.5))
    p["motion_opacity"] = p["motion_opacity"].at[:nd].set(0.5)
    p["motion_opacity_center"] = p["motion_opacity_center"].at[:nd, 0].set(1.0)
    p["motion_opacity_center"] = p["motion_opacity_center"].at[:nd, 1].set(2.5)
    p["motion_opacity_var"] = p["motion_opacity_var"].at[:nd].set(1.0)
    p["motion_scaling"] = p["motion_scaling"].at[:nd].set(-3.0)
    return base._replace(params=p, static_mask=model.static_mask,
                         dynamic_mask=base.dynamic_mask.at[:nd].set(True), stats=base.stats,
                         keyframe_num=jnp.asarray(kf, jnp.int32), duration=model.duration)


def _anisotropic(model, seed=3):
    """Seeded per-axis scales and rotations: with isotropic splats (the KNN
    init, the dynamic splats' -3.0) the covariance does not depend on the
    rotation, and its gradient is rounding noise."""
    rng = np.random.default_rng(seed)
    p = dict(model.params)
    for s_key, r_key in (("scaling", "rotation"), ("motion_scaling", "motion_rotation")):
        p[s_key] = p[s_key] + jnp.asarray(rng.normal(size=p[s_key].shape).astype(np.float32)
                                          * 0.4)
        p[r_key] = jnp.asarray(rng.normal(size=p[r_key].shape).astype(np.float32))
    return model._replace(params=p)


@functools.lru_cache(maxsize=None)
def _scene(dynamic: bool, interp: str = "cube", anisotropic: bool = False):
    cfg, model, cam = jts._scene()
    if interp != "cube":
        cfg = JModelConfig(**{**vars(cfg), "interp_type": interp})
    if dynamic:
        model = _with_dynamic(cfg, model)
    if anisotropic:
        model = _anisotropic(model)
    gt = np.random.default_rng(5).uniform(size=(H, W, 3)).astype(np.float32)
    return cfg, model, cam, gt


def _port(cfg, model, cam):
    return ModelConfig(**vars(cfg)), port_model(model), port_camera(cam)


# -- gradients of the math leaves -------------------------------------------

def _leaf_loss(xp, proj, colors, weights):
    """A seeded weighted sum of every differentiable projected quantity of
    the valid rows (invalid rows may hold inf or NaN)."""
    fields = (proj.xy, proj.conic, proj.opacity[:, None], proj.depth[:, None], colors)
    total = 0.0
    for f, w in zip(fields, weights):
        if xp == "jax":
            total = total + jnp.where(proj.valid[:, None], f * w, 0.0).sum()
        else:
            total = total + torch.where(proj.valid[:, None], f * torch.tensor(w), 0.0).sum()
    return total


@pytest.mark.parametrize("interp,t", [("cube", 5.5), ("pchip", 5.5), ("linear", 1.0)])
def test_math_leaf_gradients_match_jax(interp, t):
    cfg, model, cam, _ = _scene(True, interp, anisotropic=True)
    P = model.static_capacity + model.dynamic_capacity
    rng = np.random.default_rng(7)
    weights = [rng.normal(size=(P, k)).astype(np.float32) for k in (2, 3, 1, 1, 3)]

    def jloss(params, m2d):
        pts = jtemp.point_data_at_t(model._replace(params=params), cfg, jnp.asarray(t))
        proj, colors = jr.preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far,
                                            mean2d_offset=m2d)
        return _leaf_loss("jax", proj, colors, weights)

    m2d0 = jnp.zeros((P, 3), jnp.float32)
    want_p, want_m = jax.jit(jax.grad(jloss, argnums=(0, 1)))(model.params, m2d0)

    tc, tm, tcam = _port(cfg, model, cam)
    params = {k: v.clone().requires_grad_(True) for k, v in tm.params.items()}
    m2d = torch.zeros((P, 3), requires_grad=True)
    pts = ttemp.point_data_at_t(tm.replace(params=params), tc, t)
    proj, colors = tr.preprocess_points(pts, tcam, tc, near=tc.near, far=tc.far,
                                        mean2d_offset=m2d)
    loss = _leaf_loss("torch", proj, colors, weights)
    grads = torch.autograd.grad(loss, [*params.values(), m2d], allow_unused=True)
    want = {**{k: np.asarray(v) for k, v in want_p.items()}, "mean2d_offset": np.asarray(want_m)}
    for name, g in zip([*params, "mean2d_offset"], grads):
        g = np.zeros_like(want[name]) if g is None else g.numpy()
        # NaN where both packages divide by zero on padding rows (masked later)
        scale = max(1.0, np.nanmax(np.abs(want[name])))
        np.testing.assert_allclose(g, want[name], atol=5e-6 * scale, rtol=0, err_msg=name)
    # t lies outside the dynamic splats' opacity window [1.0, 2.5] (keyframe
    # units), where the envelope and its parameters take gradients
    assert not 1.0 < (t + cfg.time_shift) / cfg.time_interval < 2.5
    for name in ("xyz", "scaling", "rotation", "motion_xyz", "motion_rotation",
                 "motion_opacity_center", "motion_opacity_var", "mean2d_offset"):
        assert np.nanmax(np.abs(want[name])) > 1e-3, name  # the leaf is really exercised


# -- the loss and one whole step -------------------------------------------

CASES = [(False, 100), (True, 1000)]
CASE_IDS = ["static-it100", "dynamic-it1000"]


def _statics(cfg, capacity=CAP):
    j = jstep.StepStatics(cfg=cfg, opt=JOpt(), spatial_lr_scale=1.0, capacity=capacity,
                          chunk=64, max_per_tile=512)
    t = tstep.StepStatics(cfg=ModelConfig(**vars(cfg)), opt=OptimizationConfig(),
                          spatial_lr_scale=1.0, capacity=capacity)
    return j, t


@pytest.mark.parametrize("dynamic,iteration", CASES, ids=CASE_IDS)
def test_loss_and_aux_matches_jax(dynamic, iteration):
    cfg, model, cam, gt = _scene(dynamic)
    js, ts = _statics(cfg)
    P = model.static_capacity + model.dynamic_capacity
    z = jnp.zeros((P, 3), jnp.float32)
    fn = jax.jit(jax.value_and_grad(jstep._loss_and_aux, argnums=(0, 1, 2), has_aux=True),
                 static_argnames=("statics",))
    (want_loss, (want_res, want_ll1)), (want_p, want_m, want_f) = fn(
        model.params, z, z, model, cam, jnp.asarray(gt), jnp.asarray(1.0), jnp.zeros(3),
        jnp.asarray(iteration, jnp.int32), statics=js)

    tc, tm, tcam = _port(cfg, model, cam)
    params = {k: v.clone().requires_grad_(True) for k, v in tm.params.items()}
    m2d = torch.zeros((P, 3), requires_grad=True)
    flow_dirs = torch.zeros((P, 3), requires_grad=True)
    loss, (res, ll1) = tstep._loss_and_aux(params, m2d, flow_dirs, tm, tcam, torch.tensor(gt),
                                           1.0, torch.zeros(3), iteration, ts, device="cpu")
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(ll1.detach()), float(want_ll1), rtol=1e-6, atol=0)
    assert int(res.binning_total) == int(want_res.binning_total) <= CAP
    grads = torch.autograd.grad(loss, [*params.values(), m2d, flow_dirs], allow_unused=True)
    want = {**{k: np.asarray(v) for k, v in want_p.items()},
            "mean2d_offset": np.asarray(want_m), "flow_dirs": np.asarray(want_f)}
    # float32 noise scales with the loss's largest param gradient (the side
    # channels with their own)
    param_scale = max(np.abs(want[k]).max() for k in params if want[k].size)
    for name, g in zip([*params, "mean2d_offset", "flow_dirs"], grads):
        g = np.zeros_like(want[name]) if g is None else g.numpy()
        scale = param_scale if name in params else np.abs(want[name]).max()
        np.testing.assert_allclose(g, want[name], atol=1e-5 * scale, rtol=0, err_msg=name)
    for name in ("xyz", "f_dc", "opacity", "scaling", "mean2d_offset", "flow_dirs"):
        assert np.abs(want[name]).max() > 0, name


@pytest.mark.parametrize("dynamic,iteration", CASES, ids=CASE_IDS)
def test_train_step_matches_jax(dynamic, iteration):
    cfg, model, cam, gt = _scene(dynamic)
    js, ts = _statics(cfg)
    want = jstep.train_step(model, jinit(model.params), cam, jnp.asarray(gt), jnp.asarray(1.0),
                            jnp.zeros(3), jnp.asarray(iteration, jnp.int32), js)
    tc, tm, tcam = _port(cfg, model, cam)
    got = tstep.train_step(tm, init_state(tm.params, device="cpu"), tcam, torch.tensor(gt),
                           1.0, torch.zeros(3), iteration, ts, device="cpu")

    # The update (new - old), mu and nu are each as small as the gradient
    # makes them: compare them relative to themselves, with float32 noise
    # at 1e-5 of each array's largest entry.
    for k in want.model.params:
        old = np.asarray(model.params[k])
        for what, g, w in (("update", got.model.params[k].numpy() - old,
                            np.asarray(want.model.params[k]) - old),
                           ("mu", got.opt_state.mu[k].numpy(), np.asarray(want.opt_state.mu[k])),
                           ("nu", got.opt_state.nu[k].numpy(), np.asarray(want.opt_state.nu[k]))):
            atol = 1e-5 * np.abs(w).max() if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=f"{k} {what}")
        np.testing.assert_allclose(got.model.params[k].numpy(), np.asarray(want.model.params[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert int(got.opt_state.step) == int(want.opt_state.step) == 1
    for k in want.model.stats:
        np.testing.assert_allclose(got.model.stats[k].numpy(), np.asarray(want.model.stats[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    for k in ("static_mask", "dynamic_mask"):
        np.testing.assert_array_equal(getattr(got.model, k).numpy(),
                                      np.asarray(getattr(want.model, k)))
    np.testing.assert_allclose([float(got.loss), float(got.ll1), float(got.psnr)],
                               [float(want.loss), float(want.ll1), float(want.psnr)],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.visibility.numpy(), np.asarray(want.visibility))
    assert int(got.binning_total) == int(want.binning_total)
    assert bool(got.nan_flag) is bool(want.nan_flag) is False
    assert float(got.model.stats["denom"].sum()) > 0  # the stats did accumulate
    if dynamic:
        assert float(got.model.stats["motion_denom"].sum()) > 0


def test_train_step_learns():
    """tests/test_train_step.py::test_train_step_learns on the port: the loss
    falls by 30% in 25 steps, the stats accumulate only on visible active
    splats, and the params stay finite."""
    cfg, model, cam, _ = _scene(False)
    tc, tm, tcam = _port(cfg, model, cam)
    opt = OptimizationConfig(static_reg=0.0, feature_lr=0.05, opacity_lr=0.2)
    statics = tstep.StepStatics(cfg=tc, opt=opt, spatial_lr_scale=1.0, capacity=CAP)
    gt = tr.render(tcam, tm, tc, t=1.0, bg=(0, 0, 0), capacity=CAP, device="cpu").render
    gt = torch.clamp(gt * 0.5 + 0.2, 0, 1)
    state = init_state(tm.params, device="cpu")
    losses = []
    for i in range(25):
        out = tstep.train_step(tm, state, tcam, gt, 1.0, torch.zeros(3), i + 1, statics,
                               device="cpu")
        tm, state = out.model, out.opt_state
        losses.append(float(out.loss))
        assert not bool(out.nan_flag)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses
    stats = tm.stats
    n_active = int(tm.static_mask.sum())
    assert float(stats["denom"].max()) <= 25 and float(stats["denom"].sum()) > 0
    assert float(stats["error_denom"].sum()) > 0
    assert float(stats["denom"][n_active:].sum()) == 0
    assert (stats["xyz_error_min_timestamp"][:n_active] >= 0).sum() > 0
    for k, v in tm.params.items():
        assert bool(torch.isfinite(v).all()), k


def test_train_step_overflow_is_noop():
    """A step whose binning overflows its capacity changes no param, moment
    or stat; at a sufficient capacity the same step does update."""
    cfg, model, cam, _ = _scene(False)
    tc, tm, tcam = _port(cfg, model, cam)
    opt = OptimizationConfig(static_reg=0.0)
    gt = torch.zeros((H, W, 3))
    state = init_state(tm.params, device="cpu")
    tiny = tstep.StepStatics(cfg=tc, opt=opt, spatial_lr_scale=1.0, capacity=128)
    out = tstep.train_step(tm, state, tcam, gt, 1.0, torch.zeros(3), 1, tiny, device="cpu")
    assert int(out.binning_total) > tiny.capacity, "the scene must overflow"
    for k in tm.params:
        assert torch.equal(out.model.params[k], tm.params[k]), k
        assert torch.equal(out.opt_state.mu[k], state.mu[k]), k
        assert torch.equal(out.opt_state.nu[k], state.nu[k]), k
    assert torch.equal(out.opt_state.step, state.step)
    for k in tm.stats:
        assert torch.equal(out.model.stats[k], tm.stats[k]), k
    big = tstep.StepStatics(cfg=tc, opt=opt, spatial_lr_scale=1.0, capacity=CAP)
    out2 = tstep.train_step(tm, state, tcam, gt, 1.0, torch.zeros(3), 1, big, device="cpu")
    assert int(out2.binning_total) <= big.capacity
    assert not torch.equal(out2.model.params["xyz"], tm.params["xyz"])
    assert math.isfinite(float(out2.loss))
