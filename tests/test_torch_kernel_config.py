"""ex4dgs_tpu_torch's `KernelConfig.from_env` against the JAX package's, and
the entry points that read it.

- `from_env` gives the tile shape, depth sort and tight cull that JAX's
  `KernelConfig.from_env` parses from the same environment (unset, 16x16,
  capital X, 8x4, each boolean knob, the TPU-only variables set); where
  JAX's TPU validation refuses a tile the CUDA kernels take (8x4), the
  port takes it. Tiles the kernels cannot take (4x4, 64x32) and a malformed
  tile raise in the port.
- Under EX4DGS_TILE=16x16 EX4DGS_EXACT_SORT=1: the training CLI records
  16x16 with the exact sort in its checkpoint, and a resume under another
  environment keeps that record; every render of `render_set` takes the
  environment's config, read once per call; the port's render CLI and
  JAX's `render_cli.py`
  evaluate the model to the same frames and per-frame PSNR and SSIM, at
  tests/test_torch_eval.py's tolerances; `quality.py` trains and renders
  with it.

JAX binds its tile shape as module globals when it is imported, so a JAX
process started under an environment is stood in for by `configure` of
JAX's `from_env` under it; JAX's previous config is configured again after
each test (tests run many files per worker).
"""
import json
import os

import numpy as np
import pytest
import torch

from ex4dgs_tpu import kernel_config as jkc
from ex4dgs_tpu_torch.data.scene import Scene
from ex4dgs_tpu_torch.eval import render_sets
from ex4dgs_tpu_torch.io.checkpoint import load_checkpoint
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models.config import ModelConfig, overlay_json
from ex4dgs_tpu_torch.models.density import push
from ex4dgs_tpu_torch.train import __main__ as train_cli
from test_data_io import _write_colmap_model, _write_frames
from test_torch_eval import SCENE_ARGS, _assert_same_evaluation, _evaluate_with_both

torch.set_num_threads(2)

VARS = ("EX4DGS_TILE", "EX4DGS_EXACT_SORT", "EX4DGS_TIGHT_CULL", "EX4DGS_PAIR",
        "EX4DGS_GCHUNK", "EX4DGS_ALIGN", "EX4DGS_BUFS", "EX4DGS_PAIR_FWD",
        "EX4DGS_ALIGNED_LAYOUT", "EX4DGS_KERNEL_DOT", "EX4DGS_POWER", "EX4DGS_PACK_VJP",
        "EX4DGS_SSIM_BLUR", "EX4DGS_SCAN_DOT", "EX4DGS_UNTILE")
TPU_ONLY = {"EX4DGS_TILE": "16x16", "EX4DGS_PAIR": "2", "EX4DGS_GCHUNK": "256",
            "EX4DGS_ALIGN": "256", "EX4DGS_BUFS": "3", "EX4DGS_PAIR_FWD": "2",
            "EX4DGS_ALIGNED_LAYOUT": "1", "EX4DGS_KERNEL_DOT": "split", "EX4DGS_POWER": "mxu",
            "EX4DGS_PACK_VJP": "scatter", "EX4DGS_SSIM_BLUR": "matmul",
            "EX4DGS_SCAN_DOT": "highest", "EX4DGS_UNTILE": "aligned"}
ENVS = {"unset": {}, "16x16": {"EX4DGS_TILE": "16x16"}, "capital": {"EX4DGS_TILE": "16X32"},
        "8x4": {"EX4DGS_TILE": "8x4"}, "exact_sort": {"EX4DGS_EXACT_SORT": "1"},
        "exact_sort_0": {"EX4DGS_EXACT_SORT": "0"},
        "tight_cull": {"EX4DGS_TIGHT_CULL": "1", "EX4DGS_TILE": "32x8"},
        "tpu_only": TPU_ONLY}
ENV_16 = {"EX4DGS_TILE": "16x16", "EX4DGS_EXACT_SORT": "1"}
CFG_16 = KernelConfig(tile_x=16, tile_y=16, exact_sort=True)


def _set_env(monkeypatch, env):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture
def jax_config_of_env():
    """configure() of JAX's from_env under the current environment, as a
    JAX process started in it runs; JAX's earlier config afterwards."""
    base = jkc.current()
    try:
        yield lambda: jkc.configure(jkc.KernelConfig.from_env())
    finally:
        jkc.configure(base)


@pytest.mark.parametrize("name", ENVS)
def test_from_env_parses_as_jax(name, monkeypatch):
    _set_env(monkeypatch, ENVS[name])
    got = KernelConfig.from_env()
    # JAX's parse of the same environment; its TPU validation (tile sides
    # multiples of 8, areas multiples of 128) is held apart below
    with monkeypatch.context() as m:
        m.setattr(jkc.KernelConfig, "validate", lambda self: self)
        parsed = jkc.KernelConfig.from_env()
    assert (got.tile_x, got.tile_y, got.exact_sort, got.tight_cull) == (
        parsed.tile_x, parsed.tile_y, parsed.exact_sort, parsed.tight_cull)
    if name == "8x4":  # 32 pixels: one warp for the kernels, too small for the TPU's
        assert (got.tile_x, got.tile_y) == (8, 4)
        with pytest.raises(ValueError, match="multiple"):
            jkc.KernelConfig.from_env()
    else:
        assert jkc.KernelConfig.from_env() == parsed
    assert got == KernelConfig.from_dict(json.loads(got.to_json()))


@pytest.mark.parametrize("tile", ["4x4", "64x32", "16"])
def test_from_env_refuses_what_the_kernels_cannot_take(tile, monkeypatch):
    """4x4 is not a whole warp and 64x32 is over a block's 1024 threads
    (KernelConfig.validate); "16" is no tile."""
    _set_env(monkeypatch, {"EX4DGS_TILE": tile})
    with pytest.raises(ValueError):
        KernelConfig.from_env()


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """tests/test_torch_eval.py's on-disk scene."""
    root = str(tmp_path_factory.mktemp("kc_scene"))
    _write_colmap_model(os.path.join(root, "colmap_0", "sparse", "0"), n_cams=3, n_pts=200)
    _write_frames(root, n_cams=3, n_frames=4)
    return root


@pytest.fixture(scope="module")
def model_16(scene_root, tmp_path_factory):
    """A model directory trained by the port's CLI for 6 iterations under
    EX4DGS_TILE=16x16 EX4DGS_EXACT_SORT=1."""
    out = str(tmp_path_factory.mktemp("kc_trained") / "out")
    with pytest.MonkeyPatch.context() as m:
        _set_env(m, ENV_16)
        assert train_cli.main(["--source_path", scene_root, "--model_path", out,
                               "--iterations", "6", "--device", "cpu", *SCENE_ARGS]) == 0
    return out


def _recorded(path):
    _, _, extra = load_checkpoint(path)
    return KernelConfig.from_dict(json.loads(str(extra["kernel_config"])))


def test_training_cli_records_the_environment_and_a_resume_keeps_it(model_16, tmp_path,
                                                                     monkeypatch):
    assert _recorded(os.path.join(model_16, "chkpnt6.npz")) == CFG_16
    _set_env(monkeypatch, {"EX4DGS_TILE": "32x16", "EX4DGS_TIGHT_CULL": "1"})
    resumed = str(tmp_path / "resumed")
    cfg = json.load(open(os.path.join(model_16, "cfg_args.json")))
    assert train_cli.main(["--source_path", cfg["source_path"], "--model_path", resumed,
                           "--iterations", "8", "--start_checkpoint",
                           os.path.join(model_16, "chkpnt6.npz"), "--device", "cpu",
                           *SCENE_ARGS]) == 0
    assert _recorded(os.path.join(resumed, "chkpnt8.npz")) == CFG_16
    fresh = str(tmp_path / "fresh")
    assert train_cli.main(["--source_path", cfg["source_path"], "--model_path", fresh,
                           "--iterations", "1", "--device", "cpu", *SCENE_ARGS]) == 0
    assert _recorded(os.path.join(fresh, "chkpnt1.npz")) == KernelConfig(tight_cull=True)


def test_render_set_renders_with_the_environments_config(model_16, monkeypatch):
    """Every render of render_set (metric frames, the FPS recipe's probe,
    its timed calls and its round at the training capacity) takes the
    environment's config, read once per call."""
    _set_env(monkeypatch, ENV_16)
    seen = []
    real = render_sets.render

    def recording(*args, **kw):
        seen.append(kw["kernel_cfg"])
        return real(*args, **kw)

    monkeypatch.setattr(render_sets, "render", recording)
    cfg = overlay_json(ModelConfig(), os.path.join(model_16, "cfg_args.json"))
    scene = Scene(cfg, model_path=model_16)
    hm, _, _ = load_checkpoint(os.path.join(model_16, "chkpnt6.npz"))
    model, _ = push(hm, cfg, device="cpu")
    scene.set_sampling_len(hm.duration)
    out = render_sets.render_set(model, cfg, scene, "test", fps_inner=2, lpips_nets=(),
                                 timings={}, device="cpu")
    assert len(seen) == out["n_frames"] + 1 + 20 * 2 + 2 and set(seen) == {CFG_16}


def test_render_cli_evaluates_as_jax_under_the_environment(model_16, tmp_path, monkeypatch,
                                                          jax_config_of_env, capsys):
    """The port's render CLI and JAX's render_cli.py under EX4DGS_TILE=16x16
    EX4DGS_EXACT_SORT=1: the same evaluation of the train split, and the
    port's eval report names the config."""
    _set_env(monkeypatch, ENV_16)
    jax_config_of_env()
    assert (jkc.current().tile_x, jkc.current().tile_y, jkc.current().exact_sort) == (16, 16, True)
    dirs = _evaluate_with_both(model_16, tmp_path, "train")
    _assert_same_evaluation(dirs, model_16, 6, "train")
    report = [json.loads(line[len("eval_report "):])
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("eval_report ")]
    assert [r["kernel_config"] for r in report] == [json.loads(CFG_16.to_json())]


def test_quality_run_takes_the_environments_config(tmp_path, monkeypatch):
    from ex4dgs_tpu_torch import quality

    _set_env(monkeypatch, ENV_16)
    seen = []
    real = quality.render

    def recording(*args, **kw):
        seen.append(kw["kernel_cfg"])
        return real(*args, **kw)

    monkeypatch.setattr(quality, "render", recording)
    monkeypatch.setitem(quality.PRESETS, "kc_test", dict(
        width=32, height=24, n_static=300, n_dynamic=30, static_capacity=512,
        dynamic_capacity=64, capacity=65536, iters=2, fps=False, n_cams=2))
    out = quality.run(quality.parse_args(["--preset", "kc_test", "--out", str(tmp_path),
                                          "--device", "cpu"]))
    assert out["trainer"].kernel == CFG_16
    assert out["summary"]["kernel_config"] == json.loads(CFG_16.to_json())
    assert len(seen) == 2 * quality.N_T + len(out["rows"]) and set(seen) == {CFG_16}
    assert np.isfinite(out["summary"]["psnr"])
