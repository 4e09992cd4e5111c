"""The bench frame the compositing kernels are measured on.

`bench_scene` is bench.py's scene (100k static + 10k dynamic splats, scaling
clamped to log(0.02)) at 1352x1014, seen by one ring camera, with its
instance capacity sized from a probe render at t = 1. `pack_frame` packs the
instances at t = 1 for the forward kernel at a tile shape: the kernel's
inputs exactly as the render path builds them (`pack_view`, for any model,
camera and time). `cotangents` draws the
backward kernel's seeded O(1) cotangents for the forward's outputs, and
`bench_offsets` the frame's seeded subpixel offsets.
`cuda_ms` times a call with CUDA events. chip_smoke.py and kernel_turns.py both take the frame and the
timer from here. `write_n3v_scene` writes a seeded on-disk N3V scene (a
COLMAP binary model and per-camera PNG frames) for the training CLI.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
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


def pack_frame(scene: BenchScene, tile_x: int = 32, tile_y: int = 16,
               tight_cull: bool = False, capacity: int | None = None) -> Frame:
    """The scene's instances at t = 1 (the timestamp bench_scene sized the
    capacity at), binned (with the tight cull if asked) and packed at
    tile_x x tile_y, on the scene's device, into `capacity` slots (default
    the scene's, sized at 32x16 tiles; smaller tiles make more instances:
    1,146,753 at 16x16)."""
    return pack_view(scene.model, scene.cfg, scene.cam, 1.0, capacity or scene.capacity,
                     tile_x, tile_y, tight_cull)


def pack_view(model: GaussianModel, cfg: ModelConfig, cam: RenderCamera, t: float,
              capacity: int, tile_x: int = 32, tile_y: int = 16,
              tight_cull: bool = False) -> Frame:
    """The kernels' inputs for `model` seen by `cam` at time t, as the
    render path builds them: binned into `capacity` instance slots (it
    raises if they overflow) and packed at tile_x x tile_y, on the model's
    device."""
    kcfg = KernelConfig(tile_x=tile_x, tile_y=tile_y, tight_cull=tight_cull).validate()
    with torch.no_grad():
        pts = point_data_at_t(model, cfg, t)
        proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far,
                                         kernel_cfg=kcfg)
        gx, gy = tile_grid(cam.width, cam.height, tile_x, tile_y)
        binning = bin_gaussians(proj, gx, gy, capacity, tight_cull=tight_cull, tile_x=tile_x,
                                tile_y=tile_y)
        if int(binning.total) > capacity:
            raise ValueError(f"{int(binning.total)} instances overflow capacity {capacity}")
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


def write_n3v_scene(root: str, n_cams: int = 4, n_frames: int = 8, n_points: int = 100_000,
                    width: int = 2704, height: int = 2028, seed: int = 0,
                    views_agree: bool = True) -> str:
    """Write a seeded N3V scene under `root` and return `root`: the layout
    `data/readers.py::read_n3v_scene` reads, `colmap_0/sparse/0/` with
    cameras.bin (one PINHOLE camera per view, focal 0.8 x width),
    images.bin (camXX.png, identity rotations, centres 0.5 apart on a
    horizontal line 10 in front of the origin) and points3D.bin
    (`n_points` points in a slab 0.5 thick across the views' field at the
    origin), and `camXX/NNNN.png`, `n_frames` frames per camera.

    The frames are the views of one textured plane through the slab (z = 0),
    so that they agree with each other as a capture does: the texture is a
    seeded sum of separable cosines in the plane's coordinates, one term of
    which drifts slowly from frame to frame (the scene's motion). Each
    point is coloured as a capture's reconstruction colours it, by the
    texture at its place at frame 0, plus seeded noise of +-0.15 that
    training has to remove. The defaults are an N3V capture's: 2704x2028 frames, which
    `resolution: 2` halves to the bench frame's 1352x1014. Frames are
    written by a thread pool (numpy and PNG encoding release the GIL).

    views_agree=False writes a scene no capture gives, to show what such
    frames do to training (tests/torch_trainer_course.py): every camera but
    the first sees a texture of its own, seeded from (seed, camera), and
    every camera's drifts ten times as fast. The model and the first
    camera's frame 0 are the same as with views_agree=True."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "colmap_0", "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    focal, depth, spacing = 0.8 * width, 10.0, 0.5
    half_w, half_h = depth * width / (2 * focal), depth * height / (2 * focal)
    centres = spacing * (np.arange(n_cams) - (n_cams - 1) / 2)
    freqs = rng.uniform(0.3, 1.5, (3, 4, 2)) / half_w  # cycles per unit of X and Y
    phases = rng.uniform(0, 2 * np.pi, (3, 4, 2))
    amp = rng.uniform(0.06, 0.12, (3, 4))

    looks = [(freqs, phases, amp)] * n_cams
    if not views_agree:
        for c in range(1, n_cams):
            own = np.random.default_rng([seed, c])
            looks[c] = (own.uniform(0.3, 1.5, (3, 4, 2)) / half_w,
                        own.uniform(0, 2 * np.pi, (3, 4, 2)), own.uniform(0.06, 0.12, (3, 4)))
    rate = 0.05 if views_agree else 0.5

    def texture(x, y, t, look):
        """f32 [len(y), len(x), 3]: the plane's colour at x (columns) and y
        (rows) at frame t; term 0 of each channel drifts with t."""
        freqs, phases, amp = look
        img = np.empty((len(y), len(x), 3), np.float32)
        for ch in range(3):
            plane = np.full((len(y), len(x)), 0.5, np.float32)
            for k in range(4):
                drift = rate * t if k == 0 else 0.0
                plane += np.outer(
                    (amp[ch, k] * np.cos(2 * np.pi * freqs[ch, k, 1] * y
                                         + phases[ch, k, 1])).astype(np.float32),
                    np.cos(2 * np.pi * freqs[ch, k, 0] * x + phases[ch, k, 0] + drift
                           ).astype(np.float32))
            img[..., ch] = plane
        return np.clip(img, 0.0, 1.0)

    cams = np.zeros(n_cams, np.dtype([("id", "<i4"), ("model", "<i4"), ("w", "<u8"),
                                      ("h", "<u8"), ("params", "<f8", 4)]))
    cams["id"] = np.arange(1, n_cams + 1)
    cams["model"] = 1  # PINHOLE
    cams["w"], cams["h"] = width, height
    cams["params"] = (focal, focal, width / 2, height / 2)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(np.uint64(n_cams).tobytes() + cams.tobytes())
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(np.uint64(n_cams).tobytes())
        for i in range(n_cams):
            head = np.zeros(1, np.dtype([("id", "<i4"), ("q", "<f8", 4), ("t", "<f8", 3),
                                         ("cam", "<i4")]))
            head["id"], head["cam"] = i + 1, i + 1
            head["q"] = (1.0, 0.0, 0.0, 0.0)
            head["t"] = (-centres[i], 0.0, depth)  # t = -R c for the centre (c, 0, -depth)
            f.write(head.tobytes() + f"cam{i:02d}.png".encode() + b"\x00"
                    + np.uint64(0).tobytes())
    pts = np.zeros(n_points, np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                       ("err", "<f8"), ("track", "<u8")]))
    pts["id"] = np.arange(n_points)
    pts["xyz"] = rng.uniform((-half_w, -half_h, -0.25), (half_w, half_h, 0.25), (n_points, 3))
    noise = rng.uniform(-0.15, 0.15, (n_points, 3))
    for ch in range(3):  # texture(x, y, 0) at each point, without the outer product
        col = np.full(n_points, 0.5) + noise[:, ch]
        for k in range(4):
            col += amp[ch, k] * (np.cos(2 * np.pi * freqs[ch, k, 1] * pts["xyz"][:, 1]
                                        + phases[ch, k, 1])
                                 * np.cos(2 * np.pi * freqs[ch, k, 0] * pts["xyz"][:, 0]
                                          + phases[ch, k, 0]))
        pts["rgb"][:, ch] = np.clip(col * 255 + 0.5, 0, 255).astype(np.uint8)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(np.uint64(n_points).tobytes() + pts.tobytes())

    # pixel centres -> where their rays meet the plane z = 0
    ys = (np.arange(height) + 0.5 - height / 2) / focal * depth

    def write_frame(c, t):
        xs = (np.arange(width) + 0.5 - width / 2) / focal * depth + centres[c]
        arr = (texture(xs, ys, t, looks[c]) * 255 + 0.5).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"cam{c:02d}", f"{t:04d}.png"),
                                  compress_level=1)

    for c in range(n_cams):
        os.makedirs(os.path.join(root, f"cam{c:02d}"), exist_ok=True)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(write_frame, *zip(*[(c, t) for c in range(n_cams)
                                          for t in range(n_frames)])))
    return root
