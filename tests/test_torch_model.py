"""ex4dgs_tpu_torch model state, temporal queries, KNN init and synthetic
scenes against the JAX package.

Weights are carried across with model_from_numpy, so both packages query the
same model. Tolerances: point_data_at_t atol 1e-6 (float32 elementwise math
in the same operation order; the residue is libm exp/sin/arccos rounding);
mean_knn_dist2 rtol 1e-6 (the same candidate sets, three squared differences
summed per candidate); make_scene's KNN-derived scales atol 1e-6 and every
other array equal, since both draw the same numpy numbers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu import synthetic as jsyn
from ex4dgs_tpu.models import config as jcfg
from ex4dgs_tpu.models import state as jstate
from ex4dgs_tpu.models import temporal as jtemp
from ex4dgs_tpu.ops import knn as jknn
from ex4dgs_tpu_torch import synthetic as tsyn
from ex4dgs_tpu_torch.models import config as tcfg
from ex4dgs_tpu_torch.models import state as tstate
from ex4dgs_tpu_torch.models import temporal as ttemp
from ex4dgs_tpu_torch.ops import knn as tknn
from torch_parity import as_np, model_arrays, port_model

torch.set_num_threads(2)

INTERP = {"cube": dict(), "pchip": dict(interp_type="pchip"),
          "linear-lerp": dict(interp_type="linear", rot_interp_type="lerp")}


@pytest.fixture(scope="module", params=list(INTERP), ids=list(INTERP))
def scene(request):
    """A small JAX scene (static + dynamic) under one interpolation config,
    and its port."""
    cfg = jcfg.ModelConfig(time_interval=5, start_duration=5, duration=10, near=0.2,
                           far=100.0, **INTERP[request.param])
    model, cfg = jsyn.make_scene(n_static=500, n_dynamic=80, duration=10.0, seed=2, cfg=cfg,
                                 static_capacity=512, dynamic_capacity=96)
    model = model._replace(active_sh_degree=jnp.asarray(3, jnp.int32))
    return model, cfg, port_model(model), tcfg.ModelConfig(**vars(cfg))


def test_model_round_trip(scene):
    jm, _, tm, _ = scene
    arrays = model_arrays(jm)
    back = tstate.model_to_numpy(tm)
    assert back["params"].keys() == arrays["params"].keys()
    assert back["stats"].keys() == arrays["stats"].keys()
    for group in ("params", "stats"):
        for k, v in arrays[group].items():
            np.testing.assert_array_equal(back[group][k], v, err_msg=k)
            assert back[group][k].dtype == v.dtype, k
    for k in ("static_mask", "dynamic_mask", "active_sh_degree", "duration", "keyframe_num"):
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
        assert back[k].dtype == arrays[k].dtype, k
    again = tstate.model_from_numpy(**back, device="cpu")
    assert again.static_capacity == 512 and again.dynamic_capacity == 96
    assert again.keyframe_capacity == jm.keyframe_capacity


@pytest.mark.parametrize("breakage", ["missing", "extra", "shape", "dtype", "mask", "scalar"])
def test_model_from_numpy_rejects_mismatch(scene, breakage):
    arrays = model_arrays(scene[0])
    p = arrays["params"]
    if breakage == "missing":
        del p["xyz_disp"]
    elif breakage == "extra":
        p["bogus"] = p["xyz"]
    elif breakage == "shape":
        p["rotation"] = p["rotation"][:, :3]
    elif breakage == "dtype":
        p["opacity"] = p["opacity"].astype(np.float64)
    elif breakage == "mask":
        arrays["static_mask"] = arrays["static_mask"][:-1]
    else:
        arrays["keyframe_num"] = np.asarray(3, np.int64)
    with pytest.raises(ValueError):
        tstate.model_from_numpy(**arrays, device="cpu")


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("t", [0.0, 2.5, 7.0, 9.9])
def test_point_data_at_t(scene, mode, t):
    jm, jc, tm, tc = scene
    pj = jtemp.point_data_at_t(jm, jc, jnp.asarray(t, jnp.float32), mode=mode)
    pt = ttemp.point_data_at_t(tm, tc, t, mode=mode)
    assert pt.static_num == pj.static_num
    np.testing.assert_array_equal(as_np(pt.mask), np.asarray(pj.mask))
    for name in ("means3d", "rotations", "scales", "opacity", "features"):
        np.testing.assert_allclose(as_np(getattr(pt, name)), np.asarray(getattr(pj, name)),
                                   atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_point_data_sh_band_mask(scene, degree):
    jm, jc, tm, tc = scene
    jm = jm._replace(active_sh_degree=jnp.asarray(degree, jnp.int32))
    tm = tm.replace(active_sh_degree=torch.tensor(degree, dtype=torch.int32))
    fj = np.asarray(jtemp.point_data_at_t(jm, jc, jnp.asarray(1.0), mode=0).features)
    ft = as_np(ttemp.point_data_at_t(tm, tc, 1.0, mode=0).features)
    np.testing.assert_array_equal(ft, fj)
    assert not ft[:, (degree + 1) ** 2:].any()


def test_mean_knn_dist2():
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(3000, 3)) * [1.0, 0.4, 2.0]).astype(np.float32)
    pts[100] = pts[7]  # a duplicate point: distance 0 to its twin
    for perm in ((0, 1, 2), (1, 2, 0)):
        np.testing.assert_array_equal(
            as_np(tknn.morton_codes(torch.tensor(pts), perm)),
            np.asarray(jknn.morton_codes(jnp.asarray(pts), perm)).astype(np.int64))
    np.testing.assert_allclose(as_np(tknn.mean_knn_dist2(torch.tensor(pts), row_chunk=1024)),
                               np.asarray(jknn.mean_knn_dist2(jnp.asarray(pts))),
                               rtol=1e-6, atol=0)


def test_make_scene_and_cameras():
    jm, jc = jsyn.make_scene(n_static=2500, n_dynamic=300, duration=10.0, seed=4,
                             static_capacity=4096, dynamic_capacity=512, opacity=0.6)
    tm, tc = tsyn.make_scene(n_static=2500, n_dynamic=300, duration=10.0, seed=4,
                             static_capacity=4096, dynamic_capacity=512, opacity=0.6,
                             device="cpu")
    assert vars(tc) == vars(jc)
    want = model_arrays(jm)
    got = tstate.model_to_numpy(tm)
    for group in ("params", "stats"):
        assert got[group].keys() == want[group].keys()
        for k, v in want[group].items():
            np.testing.assert_allclose(got[group][k], v, atol=1e-6 if k == "scaling" else 0,
                                       rtol=0, err_msg=k)
    for k in ("static_mask", "dynamic_mask", "active_sh_degree", "duration", "keyframe_num"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for cj, ct in zip(jsyn.ring_cameras(3, 3.0, 96, 64, far=100.0),
                      tsyn.ring_cameras(3, 3.0, 96, 64, far=100.0, device="cpu")):
        assert (ct.width, ct.height) == (cj.width, cj.height)
        for name in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
            np.testing.assert_array_equal(as_np(getattr(ct, name)),
                                          np.asarray(getattr(cj, name)), err_msg=name)


def test_state_helpers():
    cfg_j = jcfg.ModelConfig(duration=30)
    cfg_t = tcfg.ModelConfig(duration=30)
    for n in (0, 1, 4095, 4096, 4097, 100_000):
        assert tstate.round_capacity(n) == jstate.round_capacity(n)
        assert tstate.round_capacity(n, 65536) == jstate.round_capacity(n, 65536)
    for d in (1.0, 5.0, 12.7, 300.0):
        assert tstate.required_keyframes(d, cfg_t) == jstate.required_keyframes(d, cfg_j)
    ej = model_arrays(jstate.empty_model(cfg_j, 64, 32))
    et = tstate.model_to_numpy(tstate.empty_model(cfg_t, 64, 32, device="cpu"))
    for group in ("params", "stats"):
        for k, v in ej[group].items():
            np.testing.assert_array_equal(et[group][k], v, err_msg=k)
    m = tstate.empty_model(cfg_t, 64, 0, device="cpu")
    for _ in range(5):
        m = tstate.oneup_sh_degree(m, 3)
    assert int(m.active_sh_degree) == 3 and m.active_sh_degree.dtype == torch.int32
    assert tcfg.overlay_json(cfg_t, {"time_interval": 4, "unknown": 1}).time_interval == 4
    assert tcfg.ModelConfig(interp_type="pchip").time_shift == \
        jcfg.ModelConfig(interp_type="pchip").time_shift
