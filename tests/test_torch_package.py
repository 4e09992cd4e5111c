"""The port's package boundary: what it imports, where it runs, and what its
kernel wrapper accepts.

- No file of ex4dgs_tpu_torch/ (the training CLI `train/__main__.py`, the
  quality run, the bench, the native loader, preprocess and its CLIs, and
  convert included), and
  not chip_smoke.py, imports `jax` or the JAX package
  `ex4dgs_tpu` (an AST scan, and a fresh interpreter that imports the whole
  port and finds neither module loaded).
- The entry points put their tensors on `cuda` unless given `device="cpu"`,
  and raise where there is no CUDA device; they never fall back to the CPU.
  The training and render CLIs without --device raise before they read
  anything.
- `ex4dgs_tpu_torch.kernels` imports where there is no nvcc and no GPU, and
  its wrapper refuses what the kernel does not take before anything is
  built.
"""
import ast
import contextlib
import io
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import numpy as np

import pytest
import torch

from ex4dgs_tpu_torch import bench_frame, compat, kernels, render_cli, rendering, synthetic
from ex4dgs_tpu_torch import viewer as viewer_mod
from ex4dgs_tpu_torch.data import readers
from ex4dgs_tpu_torch.data.cameras import CameraInfo, camera_from_info
from ex4dgs_tpu_torch.data.scene import ImagePrefetcher, Scene
from ex4dgs_tpu_torch.eval import metrics, render_sets
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models import density, optimizer, state
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.temporal import point_data_at_t
from ex4dgs_tpu_torch.ops import rasterize_cuda
from ex4dgs_tpu_torch.parallel import make_mesh, step_dp
from ex4dgs_tpu_torch.probes import outspec, unaligned
from ex4dgs_tpu_torch.train import __main__ as train_cli
from ex4dgs_tpu_torch.runtime import distributed
from ex4dgs_tpu_torch.train import step, trainer
from test_torch_pack_vjp import WRAPPER_FAULTS, wrapper_fault

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ex4dgs_tpu")


def _port_files():
    return sorted((ROOT / "ex4dgs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_the_scan_covers_the_training_entry_point():
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for path in ("train/__main__.py", "train/trainer.py", "models/density.py", "data/scene.py",
                 "data/readers.py", "data/cameras.py", "data/colmap.py", "io/checkpoint.py",
                 "io/model_ply.py", "io/ply.py", "render_cli.py", "eval/render_sets.py",
                 "eval/metrics.py", "eval/lpips.py", "viewer.py", "compat.py",
                 "runtime/profiling.py", "synthetic.py", "quality.py", "native/__init__.py",
                 "preprocess/colmap_db.py", "preprocess/llff.py", "preprocess/pipeline.py",
                 "preprocess/technicolor.py", "convert.py", "ops/rasterize_dense.py",
                 "parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
                 "parallel/step_dp.py", "runtime/distributed.py", "bench.py",
                 "preprocess/n3v.py"):
        assert f"ex4dgs_tpu_torch/{path}" in names, path


def _imported_roots(path: pathlib.Path):
    """Top-level module names of every absolute import in a file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) >= 15, files  # the scan found the package
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_port_loads_without_jax_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "import ex4dgs_tpu_torch, ex4dgs_tpu_torch.kernels, ex4dgs_tpu_torch.rendering\n"
        "import ex4dgs_tpu_torch.synthetic, ex4dgs_tpu_torch.ops.rasterize_tiled\n"
        "import ex4dgs_tpu_torch.train.step, ex4dgs_tpu_torch.ops.losses\n"
        "import ex4dgs_tpu_torch.models.optimizer, ex4dgs_tpu_torch.probes.unaligned\n"
        "import ex4dgs_tpu_torch.probes.outspec, ex4dgs_tpu_torch.train.trainer\n"
        "import ex4dgs_tpu_torch.train.__main__, ex4dgs_tpu_torch.models.density\n"
        "import ex4dgs_tpu_torch.data.scene, ex4dgs_tpu_torch.io.checkpoint\n"
        "import ex4dgs_tpu_torch.render_cli, ex4dgs_tpu_torch.eval.render_sets\n"
        "import ex4dgs_tpu_torch.eval.metrics, ex4dgs_tpu_torch.eval.lpips\n"
        "import ex4dgs_tpu_torch.viewer, ex4dgs_tpu_torch.compat, ex4dgs_tpu_torch.runtime\n"
        "import ex4dgs_tpu_torch.quality, ex4dgs_tpu_torch.native, ex4dgs_tpu_torch.convert\n"
        "import ex4dgs_tpu_torch.preprocess.pipeline, ex4dgs_tpu_torch.preprocess.technicolor\n"
        "import ex4dgs_tpu_torch.ops.rasterize_dense, ex4dgs_tpu_torch.parallel.step_dp\n"
        "import ex4dgs_tpu_torch.runtime.distributed, ex4dgs_tpu_torch.bench\n"
        "import ex4dgs_tpu_torch.preprocess.n3v\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not loaded, loaded\n"
        "assert not ex4dgs_tpu_torch.kernels._libs\n"
        "assert ex4dgs_tpu_torch.native._lib is None\n"
        "print('ok')\n")
    # An empty PATH: importing the kernels module must not look for nvcc.
    env = {**os.environ, "PATH": "", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_precision_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.fixture
def no_cuda(monkeypatch):
    """The port as it behaves on a machine without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_model():
    model, cfg = synthetic.make_scene(n_static=200, n_dynamic=20, seed=1, device="cpu")
    cam = synthetic.ring_cameras(1, 3.0, 64, 32, far=cfg.far, device="cpu")[0]
    return model, cfg, cam


def _call(entry, device, model, cfg, cam):
    kw = {} if device is None else {"device": device}
    if entry == "make_scene":
        return synthetic.make_scene(n_static=50, n_dynamic=5, **kw)
    if entry == "make_mesh":
        return make_mesh(**kw)
    if entry == "initialize":
        return distributed.initialize(**kw)
    if entry == "make_sharded_train_step":
        statics = step.StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                                   capacity=65536)
        sharded = step_dp.make_sharded_train_step(statics, make_mesh(device="cpu"), **kw)
        return sharded(model, optimizer.init_state(model.params, device="cpu"), cam,
                       torch.zeros((cam.height, cam.width, 3)), 1.0, (0, 0, 0), 1)
    if entry == "ring_cameras":
        return synthetic.ring_cameras(2, 3.0, 64, 32, **kw)
    if entry == "lookat_camera":
        return synthetic.lookat_camera((0, 0, -3), (0, 0, 0), (0, 1, 0), 64, 32, **kw)
    if entry == "empty_model":
        return state.empty_model(ModelConfig(), 64, 8, **kw)
    if entry == "model_from_numpy":
        return state.model_from_numpy(**state.model_to_numpy(model), **kw)
    if entry == "camera_from_numpy":
        return rendering.RenderCamera.from_numpy(
            cam.view.numpy(), cam.proj.numpy(), cam.campos.numpy(), cam.width, cam.height,
            cam.tan_fovx.numpy(), cam.tan_fovy.numpy(), **kw)
    if entry == "render":
        return rendering.render(cam, model, cfg, t=1.0, bg=(0, 0, 0), capacity=65536, **kw)
    if entry == "render_points":
        return rendering.render_points(point_data_at_t(model, cfg, 1.0), cam, cfg,
                                       bg=(0, 0, 0), capacity=65536, **kw)
    if entry == "init_state":
        return optimizer.init_state(model.params, **kw)
    if entry == "train_step":
        statics = step.StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                                   capacity=65536)
        return step.train_step(model, optimizer.init_state(model.params, device="cpu"), cam,
                               torch.zeros((cam.height, cam.width, 3)), 1.0, (0, 0, 0), 1,
                               statics, **kw)
    if entry == "probe_unaligned_main":
        return unaligned.main(**kw, n=4096, t=8, reps=1)
    if entry == "probe_outspec_main":
        return outspec.main(**kw, t=3, reps=1)
    if entry == "probe_make_src":
        return unaligned.make_src(4096, **kw)
    if entry == "push":
        hm = density.pull(model, optimizer.init_state(model.params, device="cpu"))
        return density.push(hm, cfg, **kw)
    if entry == "render_camera":
        return camera_from_info(_camera_info(), 0, 1).render_camera(**kw)
    if entry == "prefetcher_cache":
        pf = ImagePrefetcher(**kw)
        pf.close()
        return pf
    if entry == "trainer":
        return trainer.Trainer(cfg, OptimizationConfig(), _memory_scene(cfg), **kw)
    if entry == "train_cli":
        with tempfile.TemporaryDirectory() as root:
            bench_frame.write_n3v_scene(root, n_cams=2, n_frames=2, n_points=40, width=64,
                                        height=48)
            argv = ["--source_path", root, "--model_path", os.path.join(root, "out"),
                    "--iterations", "1", "--quiet", "--start_duration", "1",
                    "--time_interval", "1", "--time_pad", "1"]
            rc = train_cli.main(argv + (["--device", device] if device else []))
            return rc, os.path.exists(os.path.join(root, "out", "chkpnt1.npz"))
    if entry == "make_surface_scene":
        return synthetic.make_surface_scene(n_static=60, n_dynamic=6, **kw)
    if entry == "rig_cameras":
        return synthetic.rig_cameras(2, 3.0, 64, 32, **kw)
    if entry == "quality":
        from ex4dgs_tpu_torch import quality

        quality.PRESETS["package_test"] = dict(
            width=32, height=24, n_static=300, n_dynamic=30, static_capacity=512,
            dynamic_capacity=64, capacity=65536, iters=2, fps=False, n_cams=2)
        try:
            with tempfile.TemporaryDirectory() as root:
                args = quality.parse_args(["--preset", "package_test", "--out", root]
                                          + (["--device", device] if device else []))
                return quality.run(args)["summary"]
        finally:
            del quality.PRESETS["package_test"]
    if entry == "CGaussianModel":
        gm = compat.CGaussianModel(sh_degree=3, duration=4, interval=2, **kw)
        rng = np.random.default_rng(0)
        return gm.create_from_pcd(rng.normal(size=(20, 3)), rng.uniform(size=(20, 3)), 1.0)
    if entry == "LPIPS":
        return metrics.LPIPS("alex", **kw)
    if entry == "viewer_receive":
        v = viewer_mod.NetworkViewer(port=0, **kw)
        a, b = socket.socketpair()
        try:
            v.conn = a
            msg = json.dumps({"resolution_x": 64, "resolution_y": 32, "train": False,
                              "fov_x": 1.0, "fov_y": 0.6, "shs_python": False,
                              "rot_scale_python": False, "keep_alive": False,
                              "scaling_modifier": 1.0, "view_matrix": np.eye(4).ravel().tolist(),
                              "view_projection_matrix": np.eye(4).ravel().tolist()}).encode()
            b.sendall(len(msg).to_bytes(4, "little") + msg)
            return v.receive()
        finally:
            a.close()
            b.close()
            v.close()
    if entry == "bench":
        from unittest import mock

        from ex4dgs_tpu_torch import bench

        small = {"BENCH_W": "64", "BENCH_H": "48", "BENCH_STATIC": "300",
                 "BENCH_DYNAMIC": "30", "BENCH_ITERS": "1", "BENCH_REPEATS": "1"}
        with mock.patch.dict(os.environ, small), contextlib.redirect_stdout(io.StringIO()):
            return bench.main(device=device, argv=[])
    if entry in ("render_set", "render_cli"):
        with tempfile.TemporaryDirectory() as root:
            bench_frame.write_n3v_scene(root, n_cams=2, n_frames=2, n_points=40, width=64,
                                        height=48)
            out = os.path.join(root, "out")
            train_cli.main(["--source_path", root, "--model_path", out, "--iterations", "1",
                            "--quiet", "--start_duration", "1", "--time_interval", "1",
                            "--time_pad", "1", "--device", "cpu"])
            if entry == "render_cli":
                return render_cli.main(["--model_path", out, "--skip_train", "--fps_inner", "3"]
                                       + (["--device", device] if device else []))
            cfg = ModelConfig(source_path=root, model_path=out, time_interval=1, time_pad=1,
                              start_duration=1)
            return render_sets.render_set(model, cfg, Scene(cfg), "test", measure_fps=False,
                                          **kw)
    raise AssertionError(entry)


def _camera_info():
    return CameraInfo(uid=1, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.0, fovy=0.8,
                      image_path="unread.png", image_name="unread.png", width=64, height=32,
                      near=0.01, far=100.0, timestamp=0.0)


def _memory_scene(cfg):
    """A Scene whose frames are never read (the trainer reads them when it
    trains, not when it is built)."""
    rng = np.random.default_rng(0)
    pc = readers.PointCloud(rng.normal(size=(30, 3)).astype(np.float32),
                            rng.uniform(size=(30, 3)).astype(np.float32))
    info = readers.SceneInfo(pc, [_camera_info()], [], {"radius": 1.0}, "")
    return Scene(cfg, scene_info=info)


ENTRIES = ("make_scene", "ring_cameras", "lookat_camera", "empty_model", "model_from_numpy",
           "camera_from_numpy", "render", "render_points", "init_state", "train_step",
           "probe_unaligned_main", "probe_outspec_main", "probe_make_src", "push",
           "render_camera", "prefetcher_cache", "trainer", "train_cli", "render_set",
           "render_cli", "LPIPS", "viewer_receive", "make_surface_scene", "rig_cameras",
           "CGaussianModel", "quality", "make_mesh", "initialize", "make_sharded_train_step",
           "bench")


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_need_cuda_unless_told_cpu(no_cuda, entry):
    model, cfg, cam = _small_model()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _call(entry, device, model, cfg, cam)
    out = _call(entry, "cpu", model, cfg, cam)
    if entry == "render":
        assert out.render.device.type == "cpu" and int(out.binning_total) > 0
        assert float(out.acc.max()) > 0.0
    if entry == "train_step":
        assert out.model.device.type == "cpu" and bool(torch.isfinite(out.loss))
    if entry == "probe_make_src":
        assert out.device.type == "cpu" and out.shape == (16, 4096)
    if entry == "push":
        assert out[0].device.type == "cpu" and out[1].step.device.type == "cpu"
    if entry == "render_camera":
        assert out.view.device.type == "cpu"
    if entry == "prefetcher_cache":
        assert out.device.type == "cpu"
    if entry == "trainer":
        assert out.model.device.type == "cpu" and out.opt_state.step.device.type == "cpu"
        out.close()
    if entry == "train_cli":
        assert out == (0, True)
    if entry == "render_set":
        assert out["n_frames"] > 0 and np.isfinite(out["psnr"])
    if entry == "render_cli":
        assert out["test"]["n_frames"] > 0 and out["test"]["fps"] > 0
    if entry == "LPIPS":
        assert out.device.type == "cpu"
    if entry == "viewer_receive":
        assert out.camera.view.device.type == "cpu" and out.camera.width == 64
    if entry == "make_surface_scene":
        assert out[0].device.type == "cpu" and int(out[0].n_dynamic()) == 6
    if entry == "rig_cameras":
        assert out[0].view.device.type == "cpu"
    if entry == "CGaussianModel":
        assert out.model.device.type == "cpu"
    if entry == "quality":
        assert out["device"] == "cpu" and out["iters"] == 2 and np.isfinite(out["psnr"])
    if entry == "make_mesh":
        assert out.device.type == "cpu" and out.shape == {"data": 1, "gauss": 1}
    if entry == "initialize":
        assert out["process_count"] == 1 and out["backend"] == "none"
    if entry == "make_sharded_train_step":
        assert out.model.device.type == "cpu" and bool(torch.isfinite(out.loss))
    if entry == "bench":
        assert out["resolution"] == [64, 48] and out["card"] is None and out["value"] > 0


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    """No automatic switch to gloo: NCCL asked for (the default on CUDA)
    with more ranks on this host than it has cards, as torchrun's
    LOCAL_WORLD_SIZE says, raises before it joins anything, naming
    --dist_backend gloo. Without LOCAL_WORLD_SIZE the count of ranks on a
    host is not known before the job starts, so the check runs after
    joining (tests/test_torch_parallel_step.py holds it on spawned ranks)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in (None, "nccl"):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="--dist_backend gloo"):
            distributed.initialize("localhost:1", 2, 0, device="cuda", backend=backend)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(RuntimeError, match="3 ranks share 1"):
        distributed.initialize(device="cuda")


class _Joined(Exception):
    pass


@pytest.mark.parametrize("local_world", [None, "1"], ids=["flags", "torchrun"])
def test_nccl_ranks_on_other_hosts_are_not_refused(monkeypatch, local_world):
    """Two hosts of one card each, joined by the CLI's JAX-style flags
    (--num_processes 2, no LOCAL_WORLD_SIZE) or by torchrun
    (LOCAL_WORLD_SIZE=1): the world outnumbers this host's cards, and
    initialize goes on to join the job over NCCL."""
    joined = []

    def join(backend, **kw):
        joined.append((backend, kw["world_size"], kw["rank"]))
        raise _Joined

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda card: None)
    monkeypatch.setattr(distributed.dist, "init_process_group", join)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    with pytest.raises(_Joined):
        distributed.initialize("localhost:1", 2, 1, device="cuda")
    assert joined == [("nccl", 2, 1)]


def test_bench_scene_needs_cuda_unless_told_cpu(no_cuda):
    """The bench scene is full size, so only its refusal is run here."""
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_frame.bench_scene(device)


@pytest.mark.parametrize("tile", [(32, 16), (24, 4)], ids=["32x16", "24x4"])
def test_pack_frame_packs_what_the_render_bins(tile):
    """bench_frame.pack_frame on a small scene: the instances the render
    bins at the same tile shape, detached, with ids of projected
    Gaussians."""
    model, cfg, cam = _small_model()
    scene = bench_frame.BenchScene(model, cfg, cam, total=0, capacity=65536)
    frame = bench_frame.pack_frame(scene, *tile)
    res = rendering.render(cam, model, cfg, t=1.0, bg=(0, 0, 0), capacity=65536,
                           kernel_cfg=KernelConfig(*tile), device="cpu")
    total = int(res.binning_total)
    assert 0 < total == int(frame.stops[-1]) and int(frame.starts[0]) == 0
    assert frame.data.shape == (16, 65536) and not frame.data.requires_grad
    assert frame.grid_x * tile[0] >= cam.width and frame.num_points == res.radii.shape[0]
    ids = frame.gid[:total]
    assert bool((ids >= 0).all()) and int(ids.max()) < frame.num_points


def test_render_refuses_tensors_on_another_device():
    model, cfg, cam = _small_model()
    with pytest.raises(ValueError, match="the render runs on"):
        rendering.render(cam, model, cfg, t=1.0, bg=(0, 0, 0), device="meta")


def _wrapper_args(capacity=256, tiles=6):
    data = torch.zeros((16, capacity), dtype=torch.float32)
    gid = torch.zeros(capacity, dtype=torch.int32)
    starts = torch.zeros(tiles, dtype=torch.int32)
    stops = torch.zeros(tiles, dtype=torch.int32)
    return [data, gid, starts, stops]


@pytest.mark.parametrize("fault", ["dtype", "shape", "gid_shape", "strided", "tile", "cpu"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """Every refusal happens before anything is built, so it holds here,
    where there is no nvcc; a CPU tensor is refused by the wrapper itself
    (the plain version is composite_tiles_fwd's business, not the
    kernel's)."""
    args = _wrapper_args()
    kw = dict(grid_x=3, tile_x=32, tile_y=16, track_idx=True)
    if fault == "dtype":
        args[0] = args[0].double()
    elif fault == "shape":
        args[0] = args[0][:14]
    elif fault == "gid_shape":
        args[1] = args[1][:-1]
    elif fault == "strided":
        args[2] = torch.zeros(12, dtype=torch.int32)[::2]
    elif fault == "tile":
        kw.update(tile_x=10, tile_y=10)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.composite_fwd(*args, **kw)
    assert kernels.launches == before and not kernels._libs


def _bwd_args(capacity=256, tiles=6, npix=512):
    f32 = dict(dtype=torch.float32)
    return [torch.zeros((16, capacity), **f32), torch.zeros(tiles, dtype=torch.int32),
            torch.zeros(tiles, dtype=torch.int32), torch.zeros((tiles, npix, 8), **f32),
            torch.zeros((tiles, npix, 1), **f32), torch.zeros((tiles, npix, 1), **f32),
            torch.zeros((tiles, npix, 1), **f32)]


@pytest.mark.parametrize("fault", ["dtype", "shape", "gacc_shape", "acdot_shape", "strided",
                                   "tile", "cpu"])
def test_backward_kernel_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """As for the forward wrapper: kernels.composite_bwd refuses before
    anything is built, and counts no launch."""
    args = _bwd_args()
    kw = dict(grid_x=3, tile_x=32, tile_y=16)
    if fault == "dtype":
        args[3] = args[3].double()
    elif fault == "shape":
        args[0] = args[0][:14]
    elif fault == "gacc_shape":
        args[3] = args[3][:, :, :7]
    elif fault == "acdot_shape":
        args[4] = args[4][:, :256]
    elif fault == "strided":
        args[1] = torch.zeros(12, dtype=torch.int32)[::2]
    elif fault == "tile":
        kw.update(tile_x=10, tile_y=10)
        args = _bwd_args(npix=100)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.composite_bwd(*args, **kw)
    assert kernels.launches == before and not kernels._libs


def test_backward_on_cpu_tensors_takes_the_plain_version():
    """composite_tiles_bwd on CPU tensors runs the plain version, counts no
    launch, and leaves columns outside every range zero."""
    args = _bwd_args(capacity=64, tiles=2, npix=512)
    args[0][:14] = 1.0
    args[1][:] = torch.tensor([0, 10], dtype=torch.int32)
    args[2][:] = torch.tensor([10, 20], dtype=torch.int32)
    args[3][:] = 0.5
    before = dict(kernels.launches)
    dgrad = rasterize_cuda.composite_tiles_bwd(*args, grid_x=2, tile_x=32, tile_y=16)
    assert kernels.launches == before
    assert dgrad.shape == (16, 64) and not dgrad[:, 20:].any() and not dgrad[14:].any()
    assert torch.equal(dgrad, rasterize_cuda.composite_tiles_bwd_plain(
        *args, grid_x=2, tile_x=32, tile_y=16))


def test_kernel_config_validation():
    assert KernelConfig().validate().n_pix == 512
    assert KernelConfig(tile_x=16, tile_y=16).validate().n_pix == 256
    for bad in (dict(tile_x=0), dict(tile_y=0), dict(tile_x=64, tile_y=32),
                dict(tile_x=5, tile_y=5)):
        with pytest.raises(ValueError):
            KernelConfig(**bad).validate()


def test_launch_counter_reset():
    kernels.launches["composite_fwd"] += 3
    kernels.launches["composite_bwd"] += 2
    kernels.launches["outspec_d"] += 1
    kernels.reset_launches()
    assert kernels.launches == {name: 0 for name in (
        "composite_fwd", "composite_bwd", "probe_unaligned", "outspec_a", "outspec_b",
        "outspec_c", "outspec_d", "outspec_e", "slice4d_fwd", "slice4d_bwd",
        "pack_vjp", "hexplane_fwd", "hexplane_bwd")}
    # one counter per C function, each exported by one source
    entries = [fn for fns in kernels.SOURCES.values() for fn in fns]
    assert sorted(entries) == sorted(kernels.launches) == sorted(kernels._SIGNATURES)


@pytest.mark.parametrize("fault", [*WRAPPER_FAULTS, "cpu"])
def test_pack_vjp_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """kernels.pack_vjp takes ct f32 [16, capacity], slot i32 [capacity],
    cum and counts i32 [P], contiguous, on one CUDA device; anything else
    (CPU tensors too: "cpu" has no other fault) is refused before anything
    is built, with no launch counted. The faults are
    tests/test_torch_pack_vjp.py's, which refuses them on the card."""
    args = wrapper_fault(None if fault == "cpu" else fault, "cpu")
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.pack_vjp(*args)
    assert kernels.launches == before and not kernels._libs


# The C entry points of kernels A and B as the sources of an earlier
# revision declared them, before the subpixel `offsets` and the slab's
# `tile0` parameters.
_OLDER_DECLARATIONS = {
    "composite_fwd": '''extern "C" int composite_fwd(const void* data, const void* gid, const void* starts,
                             const void* stops, void* accum, void* tfinal, void* bestidx,
                             long long capacity, int num_tiles, int grid_x, int tile_x,
                             int tile_y, int track_idx, void* stream) {''',
    "composite_bwd": '''extern "C" int composite_bwd(const void* data, const void* starts, const void* stops,
                             const void* gacc, const void* acdot, const void* gend,
                             const void* tfinal, void* dgrad, long long capacity,
                             int num_tiles, int grid_x, int tile_x, int tile_y,
                             void* stream) {''',
}


def test_declared_signatures_are_the_wrappers():
    """Every C entry point's declaration in its source gives the ctypes
    signature kernels.py binds it with."""
    for source, entries in kernels.SOURCES.items():
        text = (kernels.CSRC / f"{source}.cu").read_text()
        for entry in entries:
            params = kernels.declared_signature(text, entry)
            assert [t for _, t in params] == kernels._SIGNATURES[entry], entry
            assert params[-1][0] == "stream"


@pytest.mark.parametrize("entry", ["composite_fwd", "composite_bwd"])
def test_kernel_turns_calls_an_older_source_by_its_own_signature(entry):
    """kernel_turns binds an `--other` source by the declaration in its text
    and passes arguments by name, so a revision from before the offsets and
    tile0 parameters gets its own 14 arguments and the committed one its
    16."""
    from ex4dgs_tpu_torch import kernel_turns

    older = kernels.declared_signature(_OLDER_DECLARATIONS[entry], entry)
    committed = kernels.declared_signature((kernels.CSRC / f"{entry}.cu").read_text(), entry)
    old_names, new_names = [n for n, _ in older], [n for n, _ in committed]
    assert "offsets" not in old_names and "offsets" in new_names and "tile0" in new_names
    assert [n for n in new_names if n not in ("offsets", "tile0")] == old_names
    assert len(older) == 14 and len(committed) == len(kernels._SIGNATURES[entry]) == 16
    values = {n: f"<{n}>" for n in new_names if n != "stream"}
    assert kernel_turns.call_args(old_names, values, "<s>") == [
        "<s>" if n == "stream" else f"<{n}>" for n in old_names]
    assert kernel_turns.call_args(new_names, {**values, "offsets": None}, "<s>")[
        new_names.index("offsets")] is None
    with pytest.raises(ValueError):
        kernels.declared_signature(_OLDER_DECLARATIONS[entry], "composite_other")


def test_kernel_turns_binds_probe_outspec_b_by_name():
    """kernel_turns takes an `--other` build of probe P2b (outspec_b) and
    passes its output pointer and tile count by the names its declaration
    gives them."""
    from ex4dgs_tpu_torch import kernel_turns

    assert "outspec_b" in kernel_turns.ENTRIES
    text = (kernels.CSRC / "probe_outspec.cu").read_text()
    names = [n for n, _ in kernels.declared_signature(text, "outspec_b")]
    assert names == ["out", "num_tiles", "stream"]
    assert kernel_turns.call_args(names, {"out": 7, "num_tiles": 2752, "gacc": 1}, "<s>") == [
        7, 2752, "<s>"]


@pytest.mark.parametrize("wrapper", ["fwd", "bwd"])
@pytest.mark.parametrize("tile0", [-1, 2**31 - 3, 1.0])
def test_kernel_wrappers_refuse_a_tile0_the_kernels_do_not_take(wrapper, tile0):
    """tile0 (the grid index of the first tile) must be an int >= 0 whose
    last tile fits an int; anything else is refused before anything is
    built."""
    kw = dict(grid_x=3, tile_x=32, tile_y=16, tile0=tile0)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="tile0"):
        if wrapper == "fwd":
            kernels.composite_fwd(*_wrapper_args(), track_idx=True, **kw)
        else:
            kernels.composite_bwd(*_bwd_args(), **kw)
    assert kernels.launches == before and not kernels._libs


@pytest.mark.parametrize("wrapper", ["fwd", "bwd"])
@pytest.mark.parametrize("fault", ["dtype", "shape", "strided", "device"])
def test_kernel_wrappers_refuse_offsets_the_kernels_do_not_take(wrapper, fault):
    """The subpixel offsets must be f32 [T, P, 2], contiguous, on the
    frame's device; anything else is refused before anything is built."""
    tiles, npix = 6, 512
    off = {"dtype": torch.zeros((tiles, npix, 2), dtype=torch.float64),
           "shape": torch.zeros((tiles, npix // 2, 2)),
           "strided": torch.zeros((tiles, npix, 4))[..., ::2],
           "device": torch.zeros((tiles, npix, 2), device="meta")}[fault]
    kw = dict(grid_x=3, tile_x=32, tile_y=16, offsets=off)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="offsets"):
        if wrapper == "fwd":
            kernels.composite_fwd(*_wrapper_args(), track_idx=True, **kw)
        else:
            kernels.composite_bwd(*_bwd_args(), **kw)
    assert kernels.launches == before and not kernels._libs
