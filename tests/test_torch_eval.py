"""ex4dgs_tpu_torch's evaluation path against the JAX package's.

- Metrics (`eval/metrics.py`): psnr and ssim equal JAX's at rtol 1e-5 on
  seeded images, `ssim_skimage` exactly (both are the same float64
  numpy/scipy code); the brute-force and differs-from-torch cases of
  tests/test_eval_metrics.py.
- LPIPS (`eval/lpips.py`): per tap and in total against
  `ex4dgs_tpu.eval.lpips_jax` with tests/lpips_mirror.py's seeded random
  weights (rtol 1e-4, atol 1e-6, the JAX suite's LPIPS tolerance), against
  the committed goldens, loaded from EX4DGS_LPIPS_WEIGHTS, and None without
  weights.
- `render_set` and the render CLI: a model directory trained by JAX's
  `train.py` and one trained by the port's CLI, each evaluated by both
  packages' render CLIs: the same files, keys and frames, and per-frame
  PSNR and SSIM within a tolerance derived from the image tolerance the
  two packages' renders are held to (IMAGE_TOL).
"""
import json
import math
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu.eval import lpips_jax as JL
from ex4dgs_tpu.eval import metrics as JM
from ex4dgs_tpu_torch import render_cli
from ex4dgs_tpu_torch.data.scene import Scene, load_image
from ex4dgs_tpu_torch.eval import lpips as L
from ex4dgs_tpu_torch.eval import metrics as M
from ex4dgs_tpu_torch.io.checkpoint import load_checkpoint
from ex4dgs_tpu_torch.models.config import ModelConfig, overlay_json
from ex4dgs_tpu_torch.models.density import push
from ex4dgs_tpu_torch.ops.losses import ssim as ssim_fn
from ex4dgs_tpu_torch.rendering import render
from ex4dgs_tpu_torch.train import __main__ as train_cli
from lpips_mirror import make_random_weights
from test_data_io import _write_colmap_model, _write_frames
from test_eval_metrics import _brute_force_skimage_ssim

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The per-pixel tolerance between the two packages' renders
# (tests/test_pallas.py's image tolerance; the port's render tests hold it).
IMAGE_TOL = 3e-5


def _images(seed, shape=(40, 36, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + rng.normal(scale=noise, size=shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    x, y = _images(seed)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(M.psnr(tx, ty), JM.psnr(x, y), rtol=1e-5)
    np.testing.assert_allclose(M.ssim(tx, ty), JM.ssim(x, y), rtol=1e-5)
    for data_range in (1.0, 2.0):
        assert M.ssim_skimage(x, y, data_range) == JM.ssim_skimage(x, y, data_range)


def test_ssim_skimage_matches_brute_force():
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(24, 20)).astype(np.float64)
    Y = np.clip(X + rng.normal(scale=0.1, size=X.shape), 0, 1)
    np.testing.assert_allclose(M.ssim_skimage(X, Y), _brute_force_skimage_ssim(X, Y), atol=1e-7)


def test_ssim_skimage_differs_from_torch_ssim():
    """The two variants are not aliases (sample vs population covariance,
    crop vs zero-pad)."""
    x, y = _images(1, shape=(32, 32, 3), noise=0.2)
    a = M.ssim(torch.from_numpy(x), torch.from_numpy(y))
    b = M.ssim_skimage(x, y)
    assert abs(a - b) > 1e-4
    assert M.ssim_skimage(x, x) == pytest.approx(1.0, abs=1e-9)


def _lpips_inputs(net):
    """tests/test_eval_metrics.py's seeded weights and images."""
    rng = np.random.default_rng(5)
    weights = make_random_weights(net, rng)
    img_a = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    img_b = np.clip(img_a + rng.normal(scale=0.1, size=img_a.shape), 0, 1).astype(np.float32)
    return weights, img_a, img_b


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax_per_tap_and_in_total(net):
    weights, img_a, img_b = _lpips_inputs(net)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    jlayers, layers = (JL.ALEX_LAYERS, L.ALEX_LAYERS) if net == "alex" else (JL.VGG_LAYERS,
                                                                           L.VGG_LAYERS)
    assert layers == jlayers
    ta, tb = torch.from_numpy(img_a), torch.from_numpy(img_b)
    with torch.no_grad():
        got = float(L.lpips_fn(ta, tb, layers, tw))
        taps_t = [(L.unit_normalize(a), L.unit_normalize(b)) for a, b in
                  zip(L.features(L.prep(ta), layers, tw), L.features(L.prep(tb), layers, tw))]
    want = float(JL.lpips_fn(jnp.asarray(img_a), jnp.asarray(img_b), jlayers, jw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    def jprep(im):
        shift = np.array([-0.030, -0.088, -0.188], np.float32).reshape(1, 3, 1, 1)
        scale = np.array([0.458, 0.448, 0.450], np.float32).reshape(1, 3, 1, 1)
        return jnp.asarray((im.transpose(2, 0, 1)[None] - shift) / scale)

    taps_j = list(zip(JL._features(jprep(img_a), jlayers, jw),
                      JL._features(jprep(img_b), jlayers, jw)))
    assert len(taps_j) == len(taps_t) == 5
    for i, ((ja, jb), (na, nb)) in enumerate(zip(taps_j, taps_t)):
        ja, jb = np.asarray(JL._unit_normalize(ja)), np.asarray(JL._unit_normalize(jb))
        assert na.shape == ja.shape, f"{net} tap {i}"
        np.testing.assert_allclose(na.numpy(), ja, atol=2e-5, err_msg=f"{net} tap {i}")
        # this tap's share of the distance
        lin = weights[f"lin{i}_w"].reshape(1, -1, 1, 1)
        share_j = float(((ja - jb) ** 2 * lin).sum(1).mean())
        share_t = float(((na - nb) ** 2 * torch.from_numpy(lin)).sum(1).mean())
        np.testing.assert_allclose(share_t, share_j, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{net} tap {i}")


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_golden_and_loads_weights(net, tmp_path, monkeypatch):
    """The committed goldens (tools/make_lpips_golden.py, from the torch
    mirror), through the evaluator that loads the npz from
    EX4DGS_LPIPS_WEIGHTS."""
    golden = np.load(os.path.join(ROOT, "tests", "data", f"lpips_golden_{net}.npz"))
    weights, img_a, img_b = _lpips_inputs(net)
    np.savez(tmp_path / f"lpips_{net}.npz", **weights)
    monkeypatch.setenv("EX4DGS_LPIPS_WEIGHTS", str(tmp_path))
    ev = M.LPIPS(net, device="cpu")
    assert ev.available and ev.error is None and set(ev.weights) == set(weights)
    np.testing.assert_allclose(ev(img_a, img_b), float(golden["distance"]), rtol=1e-4,
                               atol=1e-6)


def test_lpips_gated_returns_none(monkeypatch, tmp_path):
    monkeypatch.setenv("EX4DGS_LPIPS_WEIGHTS", str(tmp_path))  # empty dir
    m = M.LPIPS("alex", device="cpu")
    assert m(np.zeros((16, 16, 3), np.float32), np.zeros((16, 16, 3), np.float32)) is None
    assert not m.available and m.error and "unavailable" in m.error


# -- render_set and the render CLI ------------------------------------------

SCENE_ARGS = ["--loader", "neural3dvideo", "--resolution", "8", "--time_interval", "2",
              "--time_pad", "1", "--start_duration", "2", "--near", "0.05", "--far", "50.0",
              "--densification_interval", "100000", "--prune_invisible_interval", "100000",
              "--random_background", "false", "--quiet"]


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """tests/test_cli_eval.py's on-disk scene."""
    root = str(tmp_path_factory.mktemp("eval_scene"))
    _write_colmap_model(os.path.join(root, "colmap_0", "sparse", "0"), n_cams=3, n_pts=200)
    _write_frames(root, n_cams=3, n_frames=4)
    return root


@pytest.fixture(scope="module")
def jax_model_dir(scene_root, tmp_path_factory):
    """A model directory written by JAX's train.py (tests/test_cli_eval.py's
    run, cut to 3 iterations: what is evaluated is the directory, not the
    training)."""
    sys.path.insert(0, ROOT)
    import train as jax_train_cli

    out = str(tmp_path_factory.mktemp("jax_trained") / "out")
    jax_train_cli.main(["--source_path", scene_root, "--model_path", out, "--iterations", "3",
                        *SCENE_ARGS])
    return out


@pytest.fixture(scope="module")
def port_model_dir(scene_root, tmp_path_factory):
    """A model directory written by the port's training CLI."""
    out = str(tmp_path_factory.mktemp("port_trained") / "out")
    assert train_cli.main(["--source_path", scene_root, "--model_path", out, "--iterations",
                           "30", "--device", "cpu", *SCENE_ARGS]) == 0
    return out


def _evaluate_with_both(model_dir, tmp_path, split):
    """Copies of the model directory evaluated by JAX's render_cli.py and by
    the port's render CLI on one split. The test split runs the FPS recipe
    at fps_inner 1 (JAX's CLI renders ~0.5 s a frame on the CPU): its
    timings are then empty, NaN in both; the port's FPS path is timed in
    test_render_cli_both_splits."""
    sys.path.insert(0, ROOT)
    import render_cli as jax_render_cli

    args = ["--skip_train", "--fps_inner", "1"] if split == "test" else ["--skip_test"]
    dirs = {}
    for name, cli, extra in (("jax", jax_render_cli, []), ("port", render_cli,
                                                            ["--device", "cpu"])):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(model_dir, dirs[name])
        if split == "test":
            with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):  # mean of no times
                cli.main(["--model_path", dirs[name], *args, *extra])
        else:
            cli.main(["--model_path", dirs[name], *args, *extra])
    return dirs


def _metric_tolerances(model_dir, it, split):
    """Per frame of the split, how far PSNR and SSIM may move when every pixel of
    the render moves by IMAGE_TOL: to first order |dPSNR| <= (20 / ln 10)
    IMAGE_TOL / rmse (|d mse| <= 2 rmse IMAGE_TOL) and |dSSIM| <= IMAGE_TOL
    sum |dSSIM/dpixel| (autograd of the port's SSIM), each doubled for the
    higher-order terms, plus the float32 evaluation of either metric
    (1e-5 dB; 1e-5 of SSIM, where the variances cancel against C2)."""
    cfg = overlay_json(ModelConfig(), os.path.join(model_dir, "cfg_args.json"))
    scene = Scene(cfg, model_path=model_dir)
    hm, _, _ = load_checkpoint(os.path.join(model_dir, f"chkpnt{it}.npz"))
    model, _ = push(hm, cfg, device="cpu")
    scene.set_sampling_len(hm.duration)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0])
    tols = []
    cams = scene.sampled_test_cameras() if split == "test" else scene.sampled_train_cameras()
    for cam in cams:
        with torch.no_grad():
            img = render(cam.render_camera("cpu"), model, cfg, t=cam.timestamp, bg=bg,
                         device="cpu").render.clamp(0, 1)
        gt = torch.from_numpy(load_image(cam.image_path, (cam.width, cam.height),
                                         cam.im_scale))
        rmse = float(torch.sqrt(torch.mean((img - gt) ** 2)))
        x = img.clone().requires_grad_(True)
        ssim_fn(x, gt).backward()
        tols.append((cam.image_name, 2 * 20 / math.log(10) * IMAGE_TOL / rmse + 1e-5,
                     2 * IMAGE_TOL * float(x.grad.abs().sum()) + 1e-5))
    return tols


def _assert_same_evaluation(dirs, model_dir, it, split):
    out = {k: os.path.join(d, split, f"ours_{it}") for k, d in dirs.items()}
    assert not any(os.path.exists(os.path.join(d, "train" if split == "test" else "test"))
                   for d in dirs.values())
    assert sorted(os.listdir(out["jax"])) == sorted(os.listdir(out["port"])) == [
        "all_metrics.json", "all_metrics_rows.json", "mean_metrics.json"]
    loaded = {k: {f: json.load(open(os.path.join(o, f))) for f in os.listdir(o)}
              for k, o in out.items()}
    j, p = loaded["jax"], loaded["port"]
    assert set(j["mean_metrics.json"]) == set(p["mean_metrics.json"])
    assert ("times" in p["mean_metrics.json"]) == (split == "test")
    assert j["mean_metrics.json"]["n_frames"] == p["mean_metrics.json"]["n_frames"] > 0
    assert set(j["all_metrics.json"]) == set(p["all_metrics.json"]) == {
        "SSIM", "SKSSIM", "SKSSIM2", "PSNR"}
    for key in j["all_metrics.json"]:
        assert set(j["all_metrics.json"][key]) == set(p["all_metrics.json"][key])
    tols = _metric_tolerances(model_dir, it, split)
    rows_j, rows_p = j["all_metrics_rows.json"], p["all_metrics_rows.json"]
    # frame names repeat across cameras (camXX/NNNN.png): rows pair by place
    assert [r["frame"] for r in rows_j] == [r["frame"] for r in rows_p] == [t[0] for t in tols]
    for rj, rp, (_, psnr_tol, ssim_tol) in zip(rows_j, rows_p, tols):
        assert set(rj) == set(rp) and rj["timestamp"] == rp["timestamp"]
        assert abs(rj["psnr"] - rp["psnr"]) <= psnr_tol, (rj, rp, psnr_tol)
        assert abs(rj["ssim"] - rp["ssim"]) <= ssim_tol, (rj, rp, ssim_tol)


def test_port_render_cli_evaluates_a_jax_trained_model(jax_model_dir, tmp_path):
    """The test split, with the FPS recipe's keys."""
    dirs = _evaluate_with_both(jax_model_dir, tmp_path, "test")
    _assert_same_evaluation(dirs, jax_model_dir, 3, "test")


def test_jax_render_cli_evaluates_a_port_trained_model(port_model_dir, tmp_path):
    """The train split (no FPS recipe in either CLI)."""
    dirs = _evaluate_with_both(port_model_dir, tmp_path, "train")
    _assert_same_evaluation(dirs, port_model_dir, 30, "train")


def test_render_cli_both_splits(port_model_dir, tmp_path, capsys):
    """Both splits with the FPS recipe (test split), the reference's keys,
    and the eval report line; on the CPU no kernel launches."""
    model_dir = str(tmp_path / "m")
    shutil.copytree(port_model_dir, model_dir)
    res = render_cli.main(["--model_path", model_dir, "--fps_inner", "3", "--device", "cpu"])
    assert set(res) == {"test", "train"} and res["train"]["n_frames"] > 0
    assert "fps" not in res["train"]
    test = res["test"]
    for key in ("PSNR", "SSIM", "SKSSIM", "SKSSIM2", "times"):
        assert np.isfinite(test[key])
    assert "LPIPS" not in test  # no weights here: no lpips_* key, as in JAX
    assert test["fps"] > 0 and test["mpixels_per_s"] > 0
    assert test["times"] == test["render_time_s"] == pytest.approx(1 / test["fps"])
    with open(os.path.join(model_dir, "test", "ours_30", "mean_metrics.json")) as f:
        assert json.load(f)["PSNR"] == test["psnr"]
    reports = [json.loads(line[len("eval_report "):])
               for line in capsys.readouterr().out.splitlines()
               if line.startswith("eval_report ")]
    assert [r["split"] for r in reports] == ["test", "train"]
    for r in reports:
        assert r["device"] == "cpu" and not any(r["kernel_launches"].values())
        assert len(r["timings"]["stage_ms"]["ssim_sk"]) == res[r["split"]]["n_frames"]
    assert reports[0]["timings"]["snug_capacity"] <= reports[0]["timings"]["capacity"]


def test_render_set_grows_an_overflowing_capacity(port_model_dir):
    """A metric render that overflows its capacity is rendered again at a
    grown one: the metrics equal those at a capacity that never
    overflowed."""
    from ex4dgs_tpu_torch.eval.render_sets import render_set

    cfg = overlay_json(ModelConfig(), os.path.join(port_model_dir, "cfg_args.json"))
    scene = Scene(cfg, model_path=port_model_dir)
    hm, _, _ = load_checkpoint(os.path.join(port_model_dir, "chkpnt30.npz"))
    model, _ = push(hm, cfg, device="cpu")
    scene.set_sampling_len(hm.duration)
    kw = dict(measure_fps=False, lpips_nets=(), device="cpu")
    small, big = {}, {}
    got = render_set(model, cfg, scene, "test", capacity=256, timings=small, **kw)
    want = render_set(model, cfg, scene, "test", capacity=1 << 20, timings=big, **kw)
    assert small["overflow_retries"] >= 1 and big["overflow_retries"] == 0
    assert small["capacity"] > 256
    assert got == want


def test_render_set_gives_the_trainers_test_report(scene_root):
    """On the model the trainer's test report rendered (no event between
    them), render_set's test PSNR over the same frames is the report's."""
    from ex4dgs_tpu_torch.data.readers import read_n3v_scene
    from ex4dgs_tpu_torch.eval.render_sets import render_set
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(source_path=scene_root, loader="neural3dvideo", resolution=8, duration=-1,
                      time_interval=2, time_pad=1, start_duration=2, near=0.05, far=50.0)
    opt = OptimizationConfig(iterations=5, densify_until_iter=0, extract_from_iter=1000,
                             prune_invisible_interval=100000, random_background=False)
    tr = Trainer(cfg, opt, Scene(cfg, scene_info=read_n3v_scene(scene_root, cfg)),
                 capacity=65536, test_iterations=(5,), device="cpu")
    (it, report), = tr.train(iterations=5)["test_reports"]
    tr.close()
    got = render_set(tr.model, cfg, tr.scene, "test", measure_fps=False, lpips_nets=(),
                     device="cpu")
    assert it == 5 and got["n_frames"] == report["n_frames"] > 0
    assert got["psnr"] == pytest.approx(report["psnr"], abs=1e-6)
