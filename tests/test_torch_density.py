"""ex4dgs_tpu_torch's density control against the JAX package's.

The cases of tests/test_density.py, each run by both packages: one HostModel
(the JAX package's `pull` of a seeded model, and the port's `pull` of the
same weights carried across) and one numpy Generator state go through the
JAX event and the port's, and every array, count and return value must be
equal exactly (the events are numpy in both packages). The test's own
checks of each event's semantics then run on the port's result.

- `pull` of the port's model equals the JAX package's `pull` of the same
  weights, array for array, with and without dynamic splats;
- `push` gives the JAX package's capacity-padded arrays exactly, and
  `pull(push(hm))` round-trips.
"""
import math

import numpy as np
import pytest
import torch

from ex4dgs_tpu.models import ModelConfig as JModelConfig
from ex4dgs_tpu.models import create_from_pcd as jcreate
from ex4dgs_tpu.models import density as JD
from ex4dgs_tpu.models.optimizer import init_state as jinit
from ex4dgs_tpu.models.state import required_keyframes
from ex4dgs_tpu_torch.models import density as D
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.temporal import point_data_at_t
from torch_parity import as_jax_host as _as_jax
from torch_parity import assert_hosts_equal as _assert_same
from torch_parity import port_pull as _port_pull

torch.set_num_threads(2)

ORIGIN = np.zeros(3, np.float32)


def _cfg(**kw):
    return JModelConfig(**{**dict(time_interval=5, time_pad=3, start_duration=5, duration=20),
                           **kw})


def _jax_model(cfg, n=50, seed=0):
    rng = np.random.default_rng(seed)
    return jcreate(rng.normal(size=(n, 3)).astype(np.float32),
                   rng.uniform(size=(n, 3)).astype(np.float32), cfg, duration=5.0,
                   static_capacity=64)


def _host(cfg=None, n=50, seed=0):
    """(cfg, the port's HostModel), its pull checked against JAX's."""
    cfg = cfg or _cfg()
    jm = _jax_model(cfg, n, seed)
    hm = _port_pull(jm)
    _assert_same(hm, JD.pull(jm, jinit(jm.params)), "pull")
    return cfg, hm


def _both(event, hm, *args, seed=None, **kw):
    """Run `event` of the port on hm and of the JAX package on a copy of it
    (each with a Generator seeded `seed` where the event draws), check that
    both agree exactly, and return the event's return value."""
    jh = _as_jax(hm)
    if seed is not None:
        kw_p = {**kw, "rng": np.random.default_rng(seed)}
        kw_j = {**kw, "rng": np.random.default_rng(seed)}
    else:
        kw_p = kw_j = kw
    out_p = getattr(D, event)(hm, *args, **kw_p)
    out_j = getattr(JD, event)(jh, *args, **kw_j)
    assert out_p == out_j, event
    _assert_same(hm, jh, event)
    return out_p


def _extracted(cfg=None, max_dur=10.0, disp=3.0, ts=2.0):
    """tests/test_density.py's extraction set-up, run by both packages."""
    cfg, hm = _host(cfg)
    hm.params["xyz_disp"][:5] = disp
    hm.stats["xyz_error_min_timestamp"][:] = ts
    n = _both("extract_dynamic_from_static", hm, cfg, ORIGIN, ts, np.ones(hm.n_static, bool),
              extent=5.0, percentile=0.9, max_dur=max_dur)
    return cfg, hm, n


def _jax_push(hm, cfg, **kw):
    return JD.push(_as_jax(hm), cfg, **kw)


def _assert_push_matches(hm, cfg, **kw):
    """The port's push of hm equals the JAX package's, padded array for
    padded array, and pulls back to hm."""
    model, state = D.push(hm, ModelConfig(**vars(cfg)), device="cpu", **kw)
    jm, js = _jax_push(hm, cfg, **kw)
    for k in jm.params:
        np.testing.assert_array_equal(model.params[k].numpy(), np.asarray(jm.params[k]), k)
        np.testing.assert_array_equal(state.mu[k].numpy(), np.asarray(js.mu[k]), k)
        np.testing.assert_array_equal(state.nu[k].numpy(), np.asarray(js.nu[k]), k)
    for k in jm.stats:
        np.testing.assert_array_equal(model.stats[k].numpy(), np.asarray(jm.stats[k]), k)
    for k in ("static_mask", "dynamic_mask", "active_sh_degree", "duration", "keyframe_num"):
        got, want = getattr(model, k).numpy(), np.asarray(getattr(jm, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, k)
    assert int(state.step) == int(js.step)
    _assert_same(D.pull(model, state), JD.pull(jm, js), "pull after push")
    return model, state


def test_pull_push_roundtrip():
    cfg, hm = _host()
    model, state = _assert_push_matches(hm, cfg, static_capacity=128)
    assert int(model.n_static()) == 50 and int(model.n_dynamic()) == 0
    assert model.static_capacity == 128
    hm2 = D.pull(model, state)
    for k in hm.params:
        np.testing.assert_array_equal(hm.params[k], hm2.params[k])
    for k in hm.stats:
        np.testing.assert_array_equal(hm.stats[k], hm2.stats[k])


def test_clone_small_high_grad():
    cfg, hm = _host()
    hm.stats["xyz_gradient_accum"][0] = 10.0
    hm.stats["denom"][0] = 1.0
    hm.params["scaling"][0] = -10.0  # tiny
    hm.stats["xyz_error_min"][0] = 0.5
    hm.stats["xyz_error_min_timestamp"][0] = 3.0
    n0 = hm.n_static
    _both("densify_and_prune", hm, cfg, OptimizationConfig(), extent=10.0, seed=0,
          min_opacity=0.0)
    assert hm.n_static == n0 + 1  # one clone
    assert hm.stats["xyz_error_min"][n0] == 0.5
    assert hm.stats["xyz_error_min_timestamp"][n0] == 3.0
    assert hm.stats["xyz_gradient_accum"].max() == 0.0


def test_split_large_high_grad():
    cfg, hm = _host()
    hm.stats["xyz_gradient_accum"][0] = 10.0
    hm.stats["denom"][0] = 1.0
    hm.params["scaling"][0] = 2.0  # large (exp(2) > percent_dense*extent)
    xyz0 = hm.params["xyz"][0].copy()
    n0 = hm.n_static
    _both("densify_and_prune", hm, cfg, OptimizationConfig(), extent=10.0, seed=0,
          min_opacity=0.0)
    assert hm.n_static == n0 + 1  # split: +2 new, original pruned
    assert not any(np.allclose(xyz0, p) for p in hm.params["xyz"])
    np.testing.assert_allclose(np.exp(hm.params["scaling"][-2:]), np.exp(2.0) / 1.6, rtol=1e-5)


def test_prune_low_opacity():
    cfg, hm = _host()
    hm.params["opacity"][:10] = -20.0  # sigmoid ~ 0 < 0.01
    n0 = hm.n_static
    _both("densify_and_prune", hm, cfg, OptimizationConfig(), extent=10.0, seed=0)
    assert hm.n_static == n0 - 10


def test_extract_dynamic_from_static():
    cfg, hm0 = _host()
    n0s = hm0.n_static
    cfg, hm, n = _extracted()
    assert n >= 5
    assert hm.n_static == n0s - n and hm.n_dynamic == n
    assert hm.params["motion_xyz"].shape[1] >= required_keyframes(10.0, cfg) - 1
    traj = hm.params["motion_xyz"][0]
    assert np.linalg.norm(traj[-1] - traj[0]) > 0
    assert (hm.stats["motion_xyz_error_min_timestamp"] == -1).all()
    # pull of a model with dynamic splats and keyframes: the JAX package's
    _assert_push_matches(hm, cfg, static_capacity=64, dynamic_capacity=32)


def test_expand_duration_extrapolates():
    cfg, hm, _ = _extracted(max_dur=5.0)
    kf0 = hm.params["motion_xyz"].shape[1]
    assert _both("expand_duration", hm, cfg, 20.0)
    assert hm.duration == 21
    kf1 = hm.params["motion_xyz"].shape[1]
    assert kf1 > kf0 and hm.keyframe_num == kf1
    x = hm.params["motion_xyz"][0]
    np.testing.assert_allclose(x[-1] - x[-2], x[-2] - x[-3], atol=1e-5)
    assert np.abs(hm.mu["motion_xyz"]).max() == 0.0


def test_cubic_diff_lifecycle():
    """interp_type='cubic_diff': motion_xyz_d is created, follows keyframe
    surgery in both packages alike, the seeded tangents reproduce the
    displacement line in the port's temporal query, and one port train
    step stays finite."""
    cfg = _cfg(interp_type="cubic_diff")
    jm = jcreate(np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32),
                 np.random.default_rng(3).uniform(size=(50, 3)).astype(np.float32),
                 cfg, duration=5.0, static_capacity=64)
    assert "motion_xyz_d" in jm.params
    hm = _port_pull(jm)
    _assert_same(hm, JD.pull(jm, jinit(jm.params)), "pull")
    hm.params["xyz_disp"][:5] = 3.0
    hm.stats["xyz_error_min_timestamp"][:] = 2.0
    n = _both("extract_dynamic_from_static", hm, cfg, ORIGIN, 2.0, np.ones(hm.n_static, bool),
              extent=5.0, percentile=0.9, max_dur=10.0)
    assert n >= 5
    assert hm.params["motion_xyz_d"].shape == hm.params["motion_xyz"].shape
    assert _both("expand_duration", hm, cfg, 20.0)
    assert hm.params["motion_xyz_d"].shape == hm.params["motion_xyz"].shape

    model, state = _assert_push_matches(hm, cfg)
    tcfg = ModelConfig(**vars(cfg))
    ps = model.static_capacity

    def dyn_xyz(t):
        return point_data_at_t(model, tcfg, t).means3d[ps:ps + n].numpy()

    d_q = dyn_xyz(4.5) - dyn_xyz(2.0)
    kf = model.params["motion_xyz"][:n].numpy()
    d_k = kf[:, 3] - kf[:, 2]
    cos = (d_q * d_k).sum(-1) / (np.linalg.norm(d_q, axis=-1) * np.linalg.norm(d_k, axis=-1)
                                 + 1e-9)
    np.testing.assert_allclose(cos, 1.0, atol=1e-3)

    from ex4dgs_tpu_torch.synthetic import lookat_camera
    from ex4dgs_tpu_torch.train.step import StepStatics, train_step

    cam = lookat_camera((0, 0, -4.0), (0, 0, 0), (0, 1, 0), 64, 48, device="cpu")
    statics = StepStatics(cfg=tcfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                          capacity=8192)
    out = train_step(model, state, cam, torch.zeros((48, 64, 3)), 2.0, torch.zeros(3), 1,
                     statics, device="cpu")
    assert math.isfinite(float(out.loss))
    assert bool(torch.isfinite(out.model.params["motion_xyz_d"]).all())


def test_adjust_temp_opa():
    cfg, hm, _ = _extracted()
    hm.params["motion_opacity_center"][:] = 100.0  # pinned way past the end
    hm.params["motion_opacity_var"][:] = 1.5
    _both("adjust_temp_opa", hm, cfg, max_dur=10.0)
    c = hm.params["motion_opacity_center"]
    assert c.max() <= (10.0 + cfg.time_shift) / cfg.time_interval - 0.2 + 1e-6
    assert (hm.params["motion_opacity_var"][:, 1] == 3.0).all()  # max(1.5, 1) * 2


def test_roundtrip_then_train_step():
    from ex4dgs_tpu_torch.synthetic import ring_cameras
    from ex4dgs_tpu_torch.train.step import StepStatics, train_step

    cfg, hm, _ = _extracted(max_dur=5.0)
    model, state = _assert_push_matches(hm, cfg, static_capacity=64, dynamic_capacity=32)
    tcfg = ModelConfig(**vars(cfg))
    cam = ring_cameras(1, 3.0, 48, 32, far=tcfg.far, device="cpu")[0]
    statics = StepStatics(cfg=tcfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                          capacity=2048)
    out = train_step(model, state, cam, torch.zeros((32, 48, 3)), 1.0, torch.zeros(3), 100,
                     statics, device="cpu")
    assert math.isfinite(float(out.loss))


def test_split_collapsed_scale_stays_finite():
    """A split of a collapsed splat (log-scale below float32's exp
    underflow) gives finite children in both packages alike."""
    cfg, hm = _host()
    hm.stats["xyz_gradient_accum"][0] = 10.0
    hm.stats["denom"][0] = 1.0
    hm.params["scaling"][0] = 2.0  # large -> split
    hm.params["scaling"][1] = -120.0  # collapsed bystander: exp underflows
    hm.stats["xyz_gradient_accum"][1] = 10.0
    hm.stats["denom"][1] = 1.0
    hm.stats["max_radii2D"][1] = 1e9  # split-eligible by screen size too
    _both("densify_and_prune", hm, cfg, OptimizationConfig(), extent=10.0, seed=0,
          min_opacity=0.0, max_screen_size=100.0)
    assert np.isfinite(hm.params["scaling"]).all()


@pytest.mark.parametrize("event", ["densify_dynamic", "prune_invisible", "prune_small",
                                   "prune_nan", "reset_opacity"])
def test_events_on_dynamic_splats_match_jax(event):
    """The events tests/test_density.py does not reach, and the dynamic
    branches of densify_and_prune (clone and split of dynamic splats with
    their temporal-opacity resampling), on a model with dynamic splats."""
    cfg, hm, n = _extracted()
    rng = np.random.default_rng(9)
    for prefix in ("", "motion_"):
        rows = hm.n_dynamic if prefix else hm.n_static
        hm.stats[f"{prefix}min_radii2D"][:] = rng.uniform(0, 10, rows).astype(np.float32)
        ts = "motion_xyz_error_min_timestamp" if prefix else "xyz_error_min_timestamp"
        hm.stats[ts][:] = np.where(rng.uniform(size=rows) < 0.3, -1.0, 1.0).astype(np.float32)
        hm.params[f"{prefix}opacity"][:] = rng.normal(size=(rows, 1)).astype(np.float32) * 3
    if event == "densify_dynamic":
        hm.stats["motion_xyz_gradient_accum"][:] = rng.uniform(0, 1e-3, n).astype(np.float32)
        hm.stats["motion_denom"][:] = 1.0
        hm.params["motion_scaling"][: n // 2] = 1.0  # large: these split
        hm.params["motion_scaling"][n // 2:] = -5.0  # small: these clone
        before = hm.n_dynamic
        _both("densify_and_prune", hm, cfg, OptimizationConfig(), extent=10.0, seed=4,
              min_opacity=0.0, min_motion_opacity=0.0)
        assert hm.n_dynamic > before
        assert (hm.params["motion_opacity_var"][before:] == 2.0).all()
    elif event == "prune_nan":
        hm.params["xyz"][3, 1] = np.nan
        hm.params["motion_xyz"][1, 2, 0] = np.nan
        ns, nd = hm.n_static, hm.n_dynamic
        _both(event, hm)
        assert (hm.n_static, hm.n_dynamic) == (ns - 1, nd - 1)
    else:
        ns, nd = hm.n_static, hm.n_dynamic
        _both(event, hm)
        if event == "reset_opacity":
            assert (1 / (1 + np.exp(-hm.params["opacity"])) <= 0.85 + 1e-6).all()
            assert np.abs(hm.mu["opacity"]).max() == 0.0
        else:
            assert hm.n_static < ns and hm.n_dynamic <= nd
