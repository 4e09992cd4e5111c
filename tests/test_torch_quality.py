"""ex4dgs_tpu_torch's quality run (`quality.py`) against the JAX package's
quality probe, `tools/tpu_probes/_tpu_quality2.py` (and the schedule of
`_cpu_surface_repro.py`), at a small size: 64x48, 4 rig cameras, 2000 +
200 splats of the surface scene.

The probe trains at import, so it is read, not imported: its
ModelConfig, OptimizationConfig and SUMMARY keys are taken from its syntax
tree, and its JAX side is rebuilt from the JAX package's functions as it
builds it.

- ground truth: the port's PNGs (rendering.render, on the CPU the plain
  version of kernel A) against the probe's (JAX's jnp oracle, max_per_tile
  4096): the float frames within 3e-5 (tests/test_pallas.py's image
  tolerance), so the 8-bit frames differ by at most 1 LSB and only where a
  value lies within 255 x 3e-5 of a rounding boundary;
- the initial model array for array: the points and colours within 1e-6
  (point_data_at_t's tolerance, tests/test_torch_model.py), the KNN-derived
  log-scales within 1e-6 (tests/test_torch_model.py's tolerance of
  mean_knn_dist2 through log and sqrt), every other array exact;
- the model config and the full, soft, no-extract and repro schedules equal
  the scripts' at 3000, 1200 and 40 iterations;
- the losses and PSNRs of the port's Trainer on the quality set-up before
  the first event (the full schedule's first is at 500) against a serial
  JAX Trainer on the same PNGs and initial cloud within rtol 1e-5
  (tests/test_torch_trainer_jax.py's tolerance);
- `main`'s SUMMARY carries the probe's keys and the port's additions, and
  its metrics JSONL its lines.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quality.py
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import quality as q

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "tools", "tpu_probes", "_tpu_quality2.py")
REPRO = os.path.join(ROOT, "tools", "tpu_probes", "_cpu_surface_repro.py")
SMALL = dict(width=64, height=48, n_static=2000, n_dynamic=200, static_capacity=2048,
             dynamic_capacity=256, capacity=65536, iters=50, fps=True, n_cams=4)
N_BEFORE_EVENT = 20


@pytest.fixture()
def small_preset(monkeypatch):
    monkeypatch.setitem(q.PRESETS, "small", SMALL)
    return "small"


def _calls(path, name):
    """Every `name(...)` call in the file at `path`, in source order."""
    tree = ast.parse(open(path).read())
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id == name]


def _kwargs(call, env):
    return {kw.arg: eval(compile(ast.Expression(kw.value), "<probe>", "eval"),
                         {"max": max, "int": int, "np": np, **env})
            for kw in call.keywords}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The probe's target, rig, ground-truth PNGs and initial model at the
    small size, built by the JAX package as the probe builds them, and the
    port's from the same seeds."""
    import jax.numpy as jnp
    from PIL import Image

    from ex4dgs_tpu.models import ModelConfig as JModelConfig
    from ex4dgs_tpu.models.state import create_from_pcd as jcreate
    from ex4dgs_tpu.models.temporal import point_data_at_t as jpoint_data_at_t
    from ex4dgs_tpu.ops.math3d import sh0_to_rgb as jsh0_to_rgb
    from ex4dgs_tpu.rendering import render as jrender
    from ex4dgs_tpu.synthetic import make_surface_scene as jsurface
    from ex4dgs_tpu.synthetic import rig_cameras as jrig

    out = tmp_path_factory.mktemp("quality")
    jcfg = JModelConfig(**_kwargs(_calls(PROBE, "ModelConfig")[0],
                                  {"FULL_SCHED": True, "os": _Env({"Q2_SH": "3"})}))
    target, _ = jsurface(n_static=SMALL["n_static"], n_dynamic=SMALL["n_dynamic"],
                         duration=8.0, seed=7, static_capacity=SMALL["static_capacity"],
                         dynamic_capacity=SMALL["dynamic_capacity"], cfg=jcfg)
    cams = jrig(SMALL["n_cams"], 3.0, SMALL["width"], SMALL["height"], far=jcfg.far)
    frames = {}
    for ci, cam in enumerate(cams):
        for t in range(q.N_T):
            img = jrender(cam, target, jcfg, t=jnp.asarray(float(t)), bg=jnp.zeros(3),
                          capacity=SMALL["capacity"], max_per_tile=4096, backend="jnp").render
            img = np.clip(np.asarray(img), 0, 1)
            frames[(ci, t)] = img
            Image.fromarray((img * 255).astype(np.uint8)).save(out / f"jax_c{ci}_t{t}.png")

    rng = np.random.default_rng(0)
    pd0 = jpoint_data_at_t(target, jcfg, jnp.asarray(0.0), mode=0)
    act = np.asarray(pd0.mask)
    pts0 = np.asarray(pd0.means3d)[act] + rng.normal(
        scale=0.02, size=(int(act.sum()), 3)).astype(np.float32)
    cols0 = np.clip(np.asarray(jsh0_to_rgb(pd0.features[act][:, 0])), 0, 1)
    init = jcreate(pts0, cols0, jcfg, duration=max(jcfg.start_duration, 1))
    init = init._replace(params={**init.params, "scaling": jnp.minimum(
        init.params["scaling"], np.log(0.03))})
    return dict(out=out, cfg=jcfg, cams=cams, frames=frames, pts0=pts0, cols0=cols0,
                init=init)


class _Env:
    """The probe's `os` as its expressions see it: only os.environ.get."""

    def __init__(self, env):
        self.environ = env


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    out = tmp_path_factory.mktemp("quality_port")
    q.PRESETS["small"] = SMALL
    try:
        cfg = q.model_config()
        target, cams = q.build_target(cfg, "surface", "small", "cpu")
        infos = q.render_ground_truth(target, cams, cfg, str(out), SMALL["capacity"], "cpu")
        pts0, cols0 = q.initial_cloud(target, cfg)
        init = q.initial_model(pts0, cols0, cfg, "cpu")
    finally:
        del q.PRESETS["small"]
    return dict(cfg=cfg, cams=cams, infos=infos, pts0=pts0, cols0=cols0, init=init)


def test_ground_truth_matches_jax_oracle(jax_side, port_side):
    from PIL import Image

    from torch_parity import port_camera

    infos = port_side["infos"]
    assert len(infos) == SMALL["n_cams"] * q.N_T
    train, test = q.split(infos)
    assert {i.uid for i in test} == {0} and len(test) == q.N_T
    assert all(i.uid != 0 for i in train) and len(train) == (SMALL["n_cams"] - 1) * q.N_T
    boundary = 255 * 3e-5
    for inf in infos:
        jcam = jax_side["cams"][inf.uid]
        np.testing.assert_allclose(port_side["cams"][inf.uid].view.numpy(),
                                   port_camera(jcam).view.numpy(), atol=0)
        np.testing.assert_allclose(inf.R, np.asarray(jcam.view)[:3, :3].T)
        want_f = jax_side["frames"][(inf.uid, int(inf.timestamp))]
        got = np.asarray(Image.open(inf.image_path)).astype(np.int32)
        want = np.asarray(Image.open(jax_side["out"] / f"jax_{inf.image_name}")).astype(np.int32)
        assert want_f.mean() > 0.02, "an empty ground-truth frame"
        diff = np.abs(got - want)
        assert diff.max() <= 1, inf.image_name
        frac = (want_f * 255)[diff > 0] % 1.0
        assert ((frac < boundary) | (frac > 1 - boundary)).all(), inf.image_name
    # the float frames: re-render one through the port and hold it to 3e-5
    from ex4dgs_tpu_torch.rendering import render
    from ex4dgs_tpu_torch.synthetic import make_surface_scene

    target, _ = make_surface_scene(n_static=SMALL["n_static"], n_dynamic=SMALL["n_dynamic"],
                                   duration=8.0, seed=7, static_capacity=SMALL["static_capacity"],
                                   dynamic_capacity=SMALL["dynamic_capacity"],
                                   cfg=port_side["cfg"], device="cpu")
    for ci, t in ((0, 0), (2, 5)):
        got_f = render(port_side["cams"][ci], target, port_side["cfg"], t=float(t),
                       bg=torch.zeros(3), capacity=SMALL["capacity"], device="cpu").render
        np.testing.assert_allclose(torch.clamp(got_f, 0, 1).numpy(),
                                   jax_side["frames"][(ci, t)], atol=3e-5)


def test_initial_model_matches_jax(jax_side, port_side):
    from torch_parity import model_arrays

    np.testing.assert_allclose(port_side["pts0"], jax_side["pts0"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(port_side["cols0"], jax_side["cols0"], atol=1e-6, rtol=0)
    from ex4dgs_tpu_torch.models.state import model_to_numpy

    got, want = model_to_numpy(port_side["init"]), model_arrays(jax_side["init"])
    for group in ("params", "stats"):
        assert sorted(got[group]) == sorted(want[group])
        for k, v in want[group].items():
            tol = 1e-6 if k in ("xyz", "f_dc", "scaling") else 0
            np.testing.assert_allclose(got[group][k], v, atol=tol, rtol=0, err_msg=k)
    for k in ("static_mask", "dynamic_mask", "active_sh_degree", "duration", "keyframe_num"):
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    n = len(jax_side["pts0"])
    assert port_side["init"].static_capacity == jax_side["init"].static_capacity
    assert float(port_side["init"].params["scaling"][:n].max()) <= np.float32(np.log(0.03))


@pytest.mark.parametrize("iters", [3000, 1200, 40])
def test_configs_are_the_scripts(iters):
    from ex4dgs_tpu.models import ModelConfig as JModelConfig
    from ex4dgs_tpu.models import OptimizationConfig as JOpt

    def fields(x):
        return {k: v for k, v in vars(x).items()}

    mc = _calls(PROBE, "ModelConfig")[0]
    for soft in (False, True):
        for sh in (3, 0):
            want = JModelConfig(**_kwargs(mc, {"FULL_SCHED": not soft,
                                               "os": _Env({"Q2_SH": str(sh)})}))
            assert fields(q.model_config(soft, sh)) == fields(want)
    full, soft = _calls(PROBE, "OptimizationConfig")
    for extract in (True, False):
        want = JOpt(**_kwargs(full, {"ITERS": iters, "extract_on": extract}))
        assert fields(q.optimization(iters, "full", extract=extract)) == fields(want)
    want = JOpt(**_kwargs(soft, {"ITERS": iters}))
    assert fields(q.optimization(iters, "full", soft=True)) == fields(want)
    repro, = _calls(REPRO, "OptimizationConfig")
    assert fields(q.optimization(iters, "repro")) == fields(
        JOpt(**_kwargs(repro, {"ITERS": iters})))
    rmc, = _calls(REPRO, "ModelConfig")
    assert fields(q.model_config()) == fields(JModelConfig(**_kwargs(rmc, {})))
    assert q.held_out_iterations(iters, "full") == tuple(range(250, iters + 1, 250))
    assert q.held_out_iterations(iters, "repro") == tuple(
        range(iters // 8, iters + 1, iters // 8))


def test_losses_match_serial_jax_trainer(jax_side, port_side, monkeypatch):
    """The quality set-up's first iterations (the full schedule, seed 1):
    the port's Trainer and a serial JAX Trainer on the same PNGs and the
    same initial cloud lose the same."""
    from ex4dgs_tpu.data.cameras import CameraInfo as JCameraInfo
    from ex4dgs_tpu.data.readers import PointCloud as JPointCloud
    from ex4dgs_tpu.data.readers import SceneInfo as JSceneInfo
    from ex4dgs_tpu.data.scene import Scene as JScene
    from ex4dgs_tpu.train.trainer import Trainer as JTrainer
    from ex4dgs_tpu_torch.data.readers import PointCloud, SceneInfo
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("EX4DGS_PIPELINE", "0")
    train, test = q.split(port_side["infos"])
    norm = {"translate": np.zeros(3), "radius": 3.0}
    opt = q.optimization(3000)
    full, _ = _calls(PROBE, "OptimizationConfig")
    from ex4dgs_tpu.models import OptimizationConfig as JOpt

    jopt = JOpt(**_kwargs(full, {"ITERS": 3000, "extract_on": True}))
    jinfo = JSceneInfo(point_cloud=JPointCloud(jax_side["pts0"], jax_side["cols0"]),
                       train_cameras=[JCameraInfo(**vars(i)) for i in train],
                       test_cameras=[JCameraInfo(**vars(i)) for i in test],
                       nerf_normalization=norm, ply_path="")
    jtr = JTrainer(jax_side["cfg"], jopt, JScene(jax_side["cfg"], scene_info=jinfo),
                   model=jax_side["init"], capacity=SMALL["capacity"], max_per_tile=4096,
                   seed=1)
    want = jtr.train(iterations=N_BEFORE_EVENT)

    info = SceneInfo(point_cloud=PointCloud(port_side["pts0"], port_side["cols0"]),
                     train_cameras=train, test_cameras=test, nerf_normalization=norm,
                     ply_path="")
    tr = Trainer(port_side["cfg"], opt, Scene(port_side["cfg"], scene_info=info),
                 model=port_side["init"], capacity=SMALL["capacity"], seed=1, device="cpu")
    got = tr.train(iterations=N_BEFORE_EVENT)
    tr.close()
    assert got["event_iterations"] == [] and jtr.overflow_count == tr.overflow_count == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5, atol=0)


def test_main_summary_has_the_scripts_keys(small_preset, tmp_path, monkeypatch, capsys):
    tree = ast.parse(open(PROBE).read())
    want = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "summary")
    keys = [k.value for k in want.keys]
    assert len(keys) == 13 and keys[0] == "config"

    monkeypatch.setattr(q, "FPS_WARMUP", 1)
    monkeypatch.setattr(q, "FPS_RENDERS", 2)
    assert q.main(["--preset", small_preset, "--iters", "50", "--device", "cpu",
                   "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("SUMMARY ")
    s = json.loads(lines[-1][len("SUMMARY "):])
    assert list(s)[:len(keys)] == keys
    assert {"psnr_by_t", "test_psnr", "kernel_launches", "ms_per_iteration",
            "ms_per_iteration_without_events", "decoder"} <= set(s)
    assert s["iters"] == 50 and s["n_cams"] == SMALL["n_cams"] and s["target"] == "surface"
    assert sorted(s["psnr_by_t"]) == [str(t) for t in range(q.N_T)]
    assert np.isfinite([s["psnr"], s["ssim"], s["ssim_sk"], s["render_fps"]]).all()
    assert s["loss_finite"] and s["render_capacity"] <= SMALL["capacity"]
    assert not any(v for st in s["kernel_launches"].values() for v in st.values())  # the CPU
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["iteration"] for r in records] == [50]
    assert set(records[0]) == {"iteration", "loss", "psnr", "n_static", "n_dynamic"}
    for name in ("model/chkpnt50.npz", "frames/c0_t0.png", "render_c0_t7.png"):
        assert (tmp_path / name).exists(), name
