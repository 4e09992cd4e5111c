"""ex4dgs_tpu_torch's bench (`python -m ex4dgs_tpu_torch.bench`) against the
root bench.py.

- `fwd_bwd_loss`'s gradient with respect to every parameter equals
  `jax.grad` of bench.py:127-132's loss, rebuilt here from the JAX package,
  on bench.py's scene cut to 3000 + 300 splats at 160x96 (the same seeded
  model and camera in both packages, a seeded ground truth), at
  tests/test_torch_train.py's loss and gradient tolerances; JAX renders
  with its jnp backend (the CPU's) at bench.py's max_per_tile, which no
  tile of this frame exceeds, and its strict kernel_dot.
- `main(device="cpu")` at 64x48 with 300 + 30 splats, 2 iterations in one
  window: one JSON line, last, holding bench.py's keys in bench.py's order
  (read from bench.py's syntax tree), then the port's; finite values; the
  lines before it comments; and, with the plain compositing versions
  counted as their kernels would be, one forward and one backward
  composite per fwd+bwd call and per train step and one forward per
  render, with and without the dominant index.
- The recipe (`measure`): two warm-up calls, windows of `iters` calls, the
  best window slower than a fifth of the median.
"""
import ast
import io
import json
import math
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu import synthetic as jsyn
from ex4dgs_tpu.ops.losses import l1_loss as jl1
from ex4dgs_tpu.ops.losses import ssim as jssim
from ex4dgs_tpu.rendering import render as jrender
from ex4dgs_tpu_torch import bench, kernels
from ex4dgs_tpu_torch.bench_frame import BenchScene, pack_frame
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models.config import ModelConfig
from ex4dgs_tpu_torch.ops import rasterize_cuda
from torch_parity import jax_kernel_dot, port_camera, port_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, CAP = 160, 96, 65536
MAX_PER_TILE = 1024  # bench.py's BENCH_MAX_PER_TILE default
SMALL = {"BENCH_W": "64", "BENCH_H": "48", "BENCH_STATIC": "300", "BENCH_DYNAMIC": "30",
         "BENCH_ITERS": "2", "BENCH_REPEATS": "1"}


def _bench_py_keys():
    """The keys of the JSON object bench.py prints, in order."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py prints no JSON object")


def test_fwd_bwd_gradient_matches_jax_grad_of_bench_py_loss():
    model, cfg = jsyn.make_scene(n_static=3000, n_dynamic=300, duration=10.0,
                                 static_capacity=3000, dynamic_capacity=300 + 6384)
    model = model._replace(params={**model.params, "scaling": jnp.minimum(
        model.params["scaling"], jnp.log(0.02))})
    cam = jsyn.ring_cameras(1, 3.0, W, H, far=cfg.far)[0]
    gt = np.random.default_rng(4).uniform(size=(H, W, 3)).astype(np.float32)

    def loss_fn(params, t, gt):  # bench.py:127-132
        m = model._replace(params=params)
        res = jrender(cam, m, cfg, t=t, bg=jnp.zeros(3), capacity=CAP,
                      max_per_tile=MAX_PER_TILE, chunk=256)
        img = res.render
        return 0.8 * jl1(img, gt) + 0.2 * (1.0 - jssim(img, gt))

    with jax_kernel_dot("split"):
        want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
            model.params, jnp.asarray(1.0), jnp.asarray(gt))

    tm = port_model(model)
    scene = BenchScene(tm, ModelConfig(**vars(cfg)), port_camera(cam), 0, CAP)
    frame = pack_frame(scene)  # the binning both packages make (tests/test_torch_binning.py)
    assert 0 < int(frame.stops[-1]) <= CAP
    assert int((frame.stops - frame.starts).max()) <= MAX_PER_TILE  # JAX truncates nothing
    params = {k: v.detach().requires_grad_(True) for k, v in tm.params.items()}
    loss = bench.fwd_bwd_loss(params, scene.model, scene.cfg, scene.cam, 1.0, torch.tensor(gt),
                              KernelConfig(), capacity=CAP)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6, atol=0)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True)))
    want = {k: np.asarray(v) for k, v in want.items()}
    scale = max(np.abs(w).max() for w in want.values() if w.size)
    for name, g in grads.items():
        g = np.zeros_like(want[name]) if g is None else g.numpy()
        np.testing.assert_allclose(g, want[name], atol=1e-5 * scale, rtol=0, err_msg=name)
    for name in ("xyz", "f_dc", "opacity", "scaling", "motion_xyz"):
        assert np.abs(want[name]).max() > 0, name  # the leaf is really exercised
    # the tick the bench times is this gradient
    tick = bench.fwd_bwd_tick(scene, torch.tensor(gt), KernelConfig())
    again = tick(1)
    assert all((a is None and g is None) or torch.equal(a, g)
               for a, g in zip(again, grads.values()))


@pytest.fixture
def counted_plain(monkeypatch):
    """The plain compositing versions counted in kernels.launches as their
    kernels' wrappers count a launch."""
    for name, fn_name in (("composite_fwd", "composite_tiles_plain"),
                          ("composite_bwd", "composite_tiles_bwd_plain")):
        real = getattr(rasterize_cuda, fn_name)

        def counted(*args, _real=real, _name=name, **kw):
            kernels.launches[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(rasterize_cuda, fn_name, counted)


def test_main_prints_bench_py_line_on_the_cpu(monkeypatch, counted_plain):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    for k in ("EX4DGS_TILE", "EX4DGS_EXACT_SORT", "EX4DGS_TIGHT_CULL", "BENCH_TRAIN_STEP",
              "BENCH_CAPACITY"):
        monkeypatch.delenv(k, raising=False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = bench.main(argv=["--device", "cpu"])
    lines = buf.getvalue().strip().splitlines()
    assert lines and all(line.startswith("#") for line in lines[:-1])
    got = json.loads(lines[-1])
    assert got == json.loads(json.dumps(ret))
    keys = _bench_py_keys()
    assert len(keys) == 11 and list(got)[:len(keys)] == keys
    assert got["metric"] == "rasterizer_fwd_bwd_throughput" and got["unit"] == "Mpixels/s/chip"
    assert got["resolution"] == [64, 48] and 0 < got["instances"] <= got["capacity"]
    assert got["kernel_config"] == json.loads(KernelConfig().to_json())
    for k in ("value", "train_step_mpix_s", "render_mpix_s", "render_noidx_mpix_s",
              "fwd_bwd_ms", "train_step_ms", "render_ms", "render_noidx_ms"):
        assert math.isfinite(got[k]) and got[k] > 0, k
    assert got["vs_baseline"] == pytest.approx(got["value"] / 40.0)
    assert got["value"] == pytest.approx(64 * 48 / got["fwd_bwd_ms"] / 1e3)
    for k in ("composite_fwd_ms", "composite_bwd_ms", "card", "cuda"):
        assert got[k] is None, k  # device figures: none on the CPU
    assert got["torch"] == torch.__version__
    launches = got["launches"]
    assert {k: launches[k] for k in ("fwd_bwd", "train_step", "render", "render_noidx")} == {
        "fwd_bwd": {"composite_fwd": 1, "composite_bwd": 1},
        "train_step": {"composite_fwd": 1, "composite_bwd": 1},
        "render": {"composite_fwd": 1, "composite_bwd": 0},
        "render_noidx": {"composite_fwd": 1, "composite_bwd": 0}}
    # the scene's probe render, then per timing one counted call, 2 warm-ups
    # and 2 timed calls
    assert launches["run"] == {"composite_fwd": 1 + 4 * 5, "composite_bwd": 2 * 5}


def test_main_follows_the_environment(monkeypatch):
    """The kernel config and sizes come from the environment; the step
    leaves the line with BENCH_TRAIN_STEP=0."""
    for k, v in {**SMALL, "EX4DGS_TILE": "16x16", "EX4DGS_EXACT_SORT": "1",
                 "BENCH_TRAIN_STEP": "0"}.items():
        monkeypatch.setenv(k, v)
    with redirect_stdout(io.StringIO()):
        got = bench.main(device="cpu", argv=[])
    assert got["kernel_config"] == {"exact_sort": True, "tight_cull": False, "tile_x": 16,
                                    "tile_y": 16}
    assert got["train_step_mpix_s"] is None and got["train_step_ms"] is None
    assert "train_step" not in got["launches"]


def test_measure_is_bench_py_recipe(monkeypatch):
    calls = []
    clock = iter([0.0, 1.0, 1.0, 1.0, 1.1, 1.106])  # windows of 100, 0 and 0.6 ms per call
    monkeypatch.setattr(bench, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    got = bench.measure(calls.append, 10, 3, "cpu")
    assert calls == [0, 1] + list(range(10)) * 3
    assert got.windows_ms == pytest.approx([100.0, 0.0, 0.6])
    # the median is 0.6 ms: the 0 ms window (faster than a fifth of it) is
    # discarded, the best of the others kept
    assert got.ms == pytest.approx(0.6)
