"""ex4dgs_tpu_torch's surface scene and camera rig (`synthetic.py`), its
compat facade (`compat.py`) and its profiling helpers
(`runtime/profiling.py`), against the JAX package's.

- The three cases of tests/test_synthetic.py on the port, plus: the surface
  scene's `model_to_numpy` equals the JAX scene's arrays exactly, and the
  rig's cameras equal JAX's.
- The case of tests/test_compat.py on the port, plus the facade's
  temporal queries equal the functional ones on the same model.
- trace: its Chrome trace and its spans.json.
"""
import json

import numpy as np
import pytest
import torch

from ex4dgs_tpu.models import ModelConfig as JModelConfig
from ex4dgs_tpu.synthetic import make_surface_scene as jmake_surface_scene
from ex4dgs_tpu.synthetic import rig_cameras as jrig_cameras
from ex4dgs_tpu_torch.compat import getmodel
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.state import model_to_numpy
from ex4dgs_tpu_torch.models.temporal import point_data_at_t
from ex4dgs_tpu_torch.ops.math3d import SH_C0
from ex4dgs_tpu_torch.rendering import render
from ex4dgs_tpu_torch.runtime import profiling
from ex4dgs_tpu_torch.synthetic import make_surface_scene, rig_cameras
from torch_parity import model_arrays

torch.set_num_threads(2)

CFG = dict(time_interval=2, time_pad=1, start_duration=8, duration=8, near=0.2, far=50.0,
           resolution=1)


def _surface(n_static=4000, n_dynamic=300, seed=3, sc=8192, dc=512):
    return make_surface_scene(n_static=n_static, n_dynamic=n_dynamic, duration=8.0, seed=seed,
                              static_capacity=sc, dynamic_capacity=dc, cfg=ModelConfig(**CFG),
                              device="cpu")


def test_make_surface_scene_structure():
    m, _ = _surface()
    assert int(m.n_static()) == 4000 and int(m.n_dynamic()) == 300
    xyz = m.params["xyz"][:4000].numpy()
    assert np.isclose(xyz[:, 1], -0.9).sum() == 2000  # half the statics on the plane
    assert np.exp(m.params["scaling"][:4000].numpy()).max() <= 0.05 + 1e-6  # surface-scale
    cols = (m.params["f_dc"][:4000, 0] * SH_C0 + 0.5).numpy()
    assert cols.min() >= 0.0 and cols.max() <= 1.0
    traj = m.params["motion_xyz"][:300].numpy()
    span = np.linalg.norm(traj.max(axis=1) - traj.min(axis=1), axis=-1)
    assert span.min() > 0.1  # rigid paths that move


@pytest.mark.parametrize("n_static,n_dynamic,seed,sc,dc", [
    (2000, 200, 1, 2048, 256), (599, 0, 7, None, None)])
def test_surface_scene_equals_jax(n_static, n_dynamic, seed, sc, dc):
    want = model_arrays(jmake_surface_scene(
        n_static=n_static, n_dynamic=n_dynamic, duration=8.0, seed=seed, static_capacity=sc,
        dynamic_capacity=dc, cfg=JModelConfig(**CFG))[0])
    got = model_to_numpy(_surface(n_static, n_dynamic, seed, sc, dc)[0])
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        pairs = [(f"{k}:{n}", g[n], w[n]) for n in w] if isinstance(w, dict) else [(k, g, w)]
        for name, a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def test_rig_cameras_two_elevations_and_equal_jax():
    cams = rig_cameras(6, 3.0, 64, 48, elevs=(0.2, 0.5), device="cpu")
    eyes = np.stack([c.campos.numpy() for c in cams])
    assert len(np.unique(np.round(eyes[:, 1], 5))) == 2  # alternating elevations
    for c in cams:  # every camera looks at the origin
        d = -c.campos.numpy() / np.linalg.norm(c.campos.numpy())
        assert np.dot(c.view.numpy()[2, :3], d) > 0.97
    for c, j in zip(cams, jrig_cameras(6, 3.0, 64, 48, elevs=(0.2, 0.5))):
        for f in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
            assert np.array_equal(getattr(c, f).numpy(), np.asarray(getattr(j, f))), f
        assert (c.width, c.height) == (j.width, j.height)


def test_surface_scene_renders_and_moves():
    m, cfg = _surface(2000, 200, 1, 2048, 256)
    cam = rig_cameras(3, 3.0, 96, 64, far=cfg.far, device="cpu")[0]
    i0, i4 = (render(cam, m, cfg, t=t, bg=torch.zeros(3), capacity=32768,
                     device="cpu").render.numpy() for t in (0.0, 4.0))
    assert i0.mean() > 0.05  # scene visible
    assert np.abs(i0 - i4).max() > 0.1  # dynamics moved


def test_compat_surface(tmp_path):
    rng = np.random.default_rng(0)
    Model = getmodel("cubic")
    gm = Model(sh_degree=3, duration=10, interval=5, time_pad=3, interp_type="cube",
               rot_interp_type="slerp", device="cpu")
    gm.create_from_pcd(rng.normal(size=(80, 3)).astype(np.float32),
                       rng.uniform(size=(80, 3)).astype(np.float32), 2.0)
    gm.training_setup(OptimizationConfig())

    xyz = gm.get_xyz_at_t(2.0)
    assert xyz.shape[1] == 3 and xyz.device.type == "cpu"
    assert torch.equal(xyz, point_data_at_t(gm.model, gm.cfg, 2.0).means3d)
    assert gm.get_opacity_at_t(2.0).shape[0] == xyz.shape[0]
    assert gm.get_features().shape[1] == 16
    assert gm.get_covariance_at_t(2.0).shape[-1] == 6
    gm.oneupSHdegree()
    assert gm.active_sh_degree == 1

    gm.prune_nan_points()
    gm.reset_opacity()
    hm = gm.capture()
    assert hm.n_static == 80

    # extraction path: some splats displaced, with seen timestamps
    hm.params["xyz_disp"][:5] = 2.0
    hm.stats["xyz_error_min_timestamp"][:] = 1.0
    gm.restore(hm)
    gm.extract_dynamic_points_from_static(np.zeros(3), 1.0, np.ones(80, bool), extent=3.0,
                                          percentile=0.9, max_dur=10.0)
    assert int(gm.model.n_dynamic()) > 0
    gm.expand_duration(20)
    gm.adjust_temp_opa()

    p = str(tmp_path / "point_cloud.ply")
    gm.save_ply(p)
    gm2 = Model(sh_degree=3, duration=21, interval=5, time_pad=3, interp_type="cube",
                device="cpu")
    gm2.load_ply(p)
    assert int(gm2.model.n_static()) == int(gm.model.n_static())
    assert int(gm2.model.n_dynamic()) == int(gm.model.n_dynamic())

    with pytest.raises(NotImplementedError):
        getmodel("unknown")


def test_step_timer_trace_and_roofline(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("ex4dgs.outer"):
            torch.ones(32, 32).sum()
            with profiling.span("ex4dgs.inner"):
                torch.ones(32, 32).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with open(tmp_path / "prof" / "spans.json") as f:
        table = json.load(f)
    assert table["calls"] == 1 and set(table["per_call"]) == {"ex4dgs.outer", "ex4dgs.inner"}
    outer, inner = table["per_call"]["ex4dgs.outer"], table["per_call"]["ex4dgs.inner"]
    assert outer["host_ms"] > inner["host_ms"] > 0
    assert outer["host_self_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"])
    assert outer["device_ms"] == inner["device_ms"] == 0.0  # no card: no device work
    assert 0 < table["coverage"]["ex4dgs.outer"] < 1
