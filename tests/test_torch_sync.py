"""On the card (marker `cuda`): the step path makes no host read.

train_step's three ways to run (its key's eager first call, the capture of
its CUDA graph with the first replay, and a replay), a no-gradient render's
three ways through its own graph, the sharded step at mesh (1, 1), a render
with dynamic points under grad and one trainer iteration's dispatch each
run under torch.cuda.set_sync_debug_mode("error") (after a warm-up call;
runtime/profiling.py::host_syncs): none may wait for the card. The file
imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_sync.py
"""
import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import kernels, upload
from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
from ex4dgs_tpu_torch.data.readers import read_n3v_scene
from ex4dgs_tpu_torch.data.scene import Scene
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.optimizer import init_state
from ex4dgs_tpu_torch.parallel import make_mesh
from ex4dgs_tpu_torch.parallel.step_dp import make_sharded_train_step
from ex4dgs_tpu_torch.rendering import default_capacity, render
from ex4dgs_tpu_torch.runtime import graphs
from ex4dgs_tpu_torch.runtime.profiling import host_syncs
from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
from ex4dgs_tpu_torch.train.step import StepStatics, clone_state, train_step
from ex4dgs_tpu_torch.train.trainer import Trainer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync check runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_step_and_render_make_no_host_read(cuda_device):
    dev = cuda_device
    model, cfg = make_scene(n_static=3000, n_dynamic=300, duration=10.0, seed=1, device=dev)
    cam = ring_cameras(1, 3.0, 160, 96, far=cfg.far, device=dev)[0]
    cap = default_capacity(model.static_capacity + model.dynamic_capacity, 160, 96)
    statics = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0, capacity=cap)
    state = init_state(model.params, device=dev)
    gt, bg = torch.zeros((96, 160, 3), device=dev), torch.zeros(3, device=dev)
    sharded = make_sharded_train_step(statics, make_mesh(device=dev), device=dev)
    # the warm-up on a copy of the state (the step updates its state in
    # place), kept alive so that the next copy lies elsewhere: another key,
    # whose three calls follow
    warm = clone_state(model, state)
    train_step(*warm, cam, gt, 2.5, bg, 700, statics, device=dev)
    m, st = clone_state(model, state)
    for how in ("eager", "captures", "replays"):
        before = kernels.graph_call_counts(dev)
        assert host_syncs(lambda: train_step(m, st, cam, gt, 2.5, bg, 700, statics,
                                             device=dev)) == [], f"train_step ({how})"
        after = kernels.graph_call_counts(dev)
        assert after[how] == before[how] + 1, (how, before, after)
    graphs.release("render")
    for how in ("eager", "captures", "replays"):
        before = kernels.graph_call_counts(dev, "render")
        with torch.no_grad():
            assert host_syncs(lambda: render(cam, model, cfg, t=7.5, bg=bg, capacity=cap,
                                             device=dev)) == [], f"render ({how})"
        after = kernels.graph_call_counts(dev, "render")
        assert after[how] == before[how] + 1, (how, before, after)
    calls = {
        "sharded step": lambda: sharded(model, state, cam, gt, 2.5, bg, 700),
        "render": lambda: render(cam, model, cfg, t=7.5, bg=bg, capacity=cap, device=dev),
    }
    for name, fn in calls.items():
        fn()
        assert host_syncs(fn) == [], name


@pytest.mark.cuda
def test_trainer_dispatch_makes_no_host_read(cuda_device, tmp_path):
    dev = cuda_device
    root = write_n3v_scene(str(tmp_path), n_cams=4, n_frames=6, n_points=300, width=640,
                           height=480, seed=1)
    cfg = ModelConfig(source_path=root, loader="neural3dvideo", resolution=8, duration=-1,
                      time_interval=2, time_pad=1, start_duration=2, near=0.05, far=50.0)
    opt = OptimizationConfig(iterations=10, densify_from_iter=1000, extract_from_iter=1000,
                             progressive_growing_steps=1000, random_background=True)
    tr = Trainer(cfg, opt, Scene(cfg, scene_info=read_n3v_scene(root, cfg)), capacity=65536,
                 seed=11, device=dev)
    tr.train(iterations=3)
    c = tr.scene.sampled_train_cameras()[0]
    g = tr.prefetcher.load(c)
    bg_np = np.full(3, 0.25, np.float32)
    try:
        assert host_syncs(lambda: tr._dispatch(4, c, c, g, upload(bg_np, dev), [c])) == []
    finally:
        tr.close()
