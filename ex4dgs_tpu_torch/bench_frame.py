"""The bench frame the compositing kernels are measured on.

`bench_scene` is bench.py's scene (100k static + 10k dynamic splats, scaling
clamped to log(0.02)) at 1352x1014, seen by one ring camera, with its
instance capacity sized from a probe render at t = 1. `pack_frame` packs the
instances at t = 1 for the forward kernel at a tile shape: the kernel's
inputs exactly as the render path builds them. `cotangents` draws the
backward kernel's seeded O(1) cotangents for the forward's outputs, and
`bench_offsets` the frame's seeded subpixel offsets.
`cuda_ms` times a call with CUDA events. chip_smoke.py and kernel_turns.py both take the frame and the
timer from here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .kernel_config import KernelConfig
from .models.config import ModelConfig
from .models.state import GaussianModel, round_capacity
from .models.temporal import point_data_at_t
from .ops.binning import bin_gaussians
from .ops.projection import tile_grid
from .ops.rasterize_cuda import pack_sorted
from .rendering import RenderCamera, preprocess_points, render
from .synthetic import make_scene, ring_cameras

W, H = 1352, 1014
PROBE_CAPACITY = 2 * 1024 * 1024


class BenchScene(NamedTuple):
    model: GaussianModel
    cfg: ModelConfig
    cam: RenderCamera
    total: int  # instances at t = 1
    capacity: int  # total + 25%, bucketed, at most PROBE_CAPACITY


class Frame(NamedTuple):
    data: torch.Tensor  # f32 [16, capacity], detached
    gid: torch.Tensor  # i32 [capacity]
    starts: torch.Tensor  # i32 [T]
    stops: torch.Tensor  # i32 [T]
    grid_x: int
    num_points: int  # Gaussians projected (ids lie in [-1, num_points))


def bench_scene(device=None) -> BenchScene:
    """The bench scene on `device` (cuda unless told otherwise)."""
    dev = resolve_device(device)
    model, cfg = make_scene(n_static=100_000, n_dynamic=10_000, duration=10.0,
                            static_capacity=100_000, dynamic_capacity=16_384, device=dev)
    model.params["scaling"] = torch.clamp_max(model.params["scaling"], math.log(0.02))
    cam = ring_cameras(1, 3.0, W, H, far=cfg.far, device=dev)[0]
    probe = render(cam, model, cfg, t=1.0, bg=torch.zeros(3, device=dev),
                   capacity=PROBE_CAPACITY, device=dev)
    total = int(probe.binning_total.item())
    return BenchScene(model, cfg, cam, total,
                      min(PROBE_CAPACITY, round_capacity(total * 5 // 4, 65536)))


def pack_frame(scene: BenchScene, tile_x: int = 32, tile_y: int = 16) -> Frame:
    """The scene's instances at t = 1 (the timestamp bench_scene sized the
    capacity at), binned and packed at tile_x x tile_y, on the scene's
    device."""
    kcfg = KernelConfig(tile_x=tile_x, tile_y=tile_y).validate()
    model, cfg, cam = scene.model, scene.cfg, scene.cam
    with torch.no_grad():
        pts = point_data_at_t(model, cfg, 1.0)
        proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far,
                                         kernel_cfg=kcfg)
        gx, gy = tile_grid(cam.width, cam.height, tile_x, tile_y)
        binning = bin_gaussians(proj, gx, gy, scene.capacity)
        flow = torch.zeros((proj.xy.shape[0], 3), device=proj.xy.device)
        data, gid = pack_sorted(proj, colors, flow, binning)
    return Frame(data, gid, binning.tile_start, binning.tile_stop, gx, proj.xy.shape[0])


def cotangents(accum: torch.Tensor, seed: int = 0):
    """(gacc f32 [T, P, 8], acdot f32 [T, P, 1], gend f32 [T, P, 1]): seeded
    standard normal cotangents of the forward's accum and tfinal on accum's
    device, and acdot = accum[..., :3] . gacc[..., :3], the backward
    kernel's inputs beside the packed frame and the forward's tfinal."""
    gen = torch.Generator(device=accum.device).manual_seed(seed)
    gacc = torch.randn(accum.shape, device=accum.device, generator=gen)
    gend = torch.randn((*accum.shape[:2], 1), device=accum.device, generator=gen)
    acdot = (accum[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
    return gacc, acdot, gend


def bench_offsets(device=None, seed: int = 11) -> torch.Tensor:
    """f32 [H, W, 2] subpixel offsets of the bench frame, U(-0.5, 0.5) drawn
    with numpy from `seed` (as tests/test_pallas.py draws its offsets), on
    `device` (cuda unless told otherwise). ops.rasterize_cuda.tile_offsets
    cuts them into a frame's per-tile blocks."""
    off = np.random.default_rng(seed).uniform(-0.5, 0.5, (H, W, 2)).astype(np.float32)
    return torch.from_numpy(off).to(resolve_device(device))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of fn() on the current stream, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps
