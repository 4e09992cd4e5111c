"""The port's bench: the root bench.py's measurement on one CUDA device.

    python -m ex4dgs_tpu_torch.bench [--device cpu]

Times, on bench.py's scene (`bench_frame.bench_scene`: 100k static + 10k
dynamic splats at 1352x1014, the capacity sized from a probe render at
t = 1), the four things bench.py times:

- fwd+bwd: `torch.autograd.grad` of bench.py:127-132's loss, 0.8 L1 +
  0.2 (1 - SSIM) of the render against a zero ground truth, with respect
  to every parameter (`fwd_bwd_loss`);
- the full `train_step` (render, loss, backward, RAdam, stat accumulators)
  at iteration 100 (`train_step_tick`; BENCH_TRAIN_STEP=0 leaves it out);
- `render` with and without the dominant-index bookkeeping (`track_idx`).

Each at t = i % 5 by bench.py's recipe (`measure`), and every render with
the kernel config of EX4DGS_TILE, EX4DGS_EXACT_SORT and EX4DGS_TIGHT_CULL
(`KernelConfig.from_env`), as bench.py renders with the JAX package's
`current()` config. The sizes come from bench.py's variables: BENCH_W,
BENCH_H, BENCH_STATIC, BENCH_DYNAMIC, BENCH_CAPACITY (the probe's capacity),
BENCH_ITERS and BENCH_REPEATS.

It prints one JSON line, last: bench.py's keys in bench.py's order and
units (`value` is the fwd+bwd rate in Mpixels/s, `vs_baseline` that rate
over BASELINE.md's 40 Mpix/s estimate), then the port's own: each timing
in ms per call; kernels A and B alone on the bench frame (CUDA events,
`bench_frame.cuda_ms`, as chip_smoke.py's kernels phase times them); the
compositing kernels' launches per call of each timing and over the whole
run; the card's name and power limit; the torch and CUDA versions. Lines
before it start with "#". The device figures are null on the CPU.

The run is on `cuda` unless --device names another device, and raises where
there is no CUDA device. Nothing is caught: a failed launch or an instance
count above the capacity ends the run with a non-zero exit and no JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import NamedTuple

import torch

from . import kernels, resolve_device
from .bench_frame import PROBE_CAPACITY, BenchScene, bench_scene, cotangents, cuda_ms, pack_frame
from .kernel_config import KernelConfig
from .models.config import OptimizationConfig
from .models.optimizer import init_state
from .ops.losses import l1_loss, ssim
from .rendering import render
from .train.step import StepStatics, clone_state, train_step

BASELINE_MPIX_S = 40.0  # BASELINE.md's estimate of the reference's fwd+bwd rate
KERNELS = ("composite_fwd", "composite_bwd")


def settings_from_env() -> dict:
    """bench.py's sizes and recipe from its environment variables, with its
    defaults (bench.py:31-35, :104)."""
    env = os.environ.get
    return dict(width=int(env("BENCH_W", 1352)), height=int(env("BENCH_H", 1014)),
                n_static=int(env("BENCH_STATIC", 100_000)),
                n_dynamic=int(env("BENCH_DYNAMIC", 10_000)),
                probe_capacity=int(env("BENCH_CAPACITY", PROBE_CAPACITY)),
                iters=int(env("BENCH_ITERS", 20)), repeats=int(env("BENCH_REPEATS", 3)),
                train_step=env("BENCH_TRAIN_STEP", "1") == "1")


class Timing(NamedTuple):
    ms: float  # ms per call of the best valid window
    windows_ms: list  # ms per call of every window, in order


def measure(tick, iters: int, repeats: int, device) -> Timing:
    """bench.py:143-166's recipe: two warm-up calls tick(0), tick(1), then
    `repeats` windows of `iters` calls tick(0..iters-1), each window ending
    in `torch.cuda.synchronize()` on a CUDA device; the best window among
    those slower than a fifth of the median.

    bench.py's guards against its TPU service are not ported: the re-exec on
    a transient backend error (bench.py:46-79) and the 300 Mpix/s ceiling
    that re-measures (bench.py:37-44, :159-166) catch a service that fails
    to start or returns before it has run the work; a CUDA device has no
    such service, and the ceiling would fire on any render under 4.6 ms."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for i in range(2):
        tick(i)
    sync()
    windows = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            tick(i)
        sync()
        windows.append((time.perf_counter() - t0) / iters * 1e3)
    median = sorted(windows)[len(windows) // 2]
    return Timing(min(w for w in windows if w > median / 5), windows)


def fwd_bwd_loss(params: dict, model, cfg, cam, t, gt: torch.Tensor,
                 kernel_cfg: KernelConfig | None, *, capacity: int) -> torch.Tensor:
    """bench.py:127-132's loss_fn: 0.8 L1 + 0.2 (1 - SSIM) of the model with
    `params` rendered at t (black background, `capacity` instance slots,
    `kernel_cfg`) against gt [H, W, 3], on gt's device. gt is an argument,
    not a constant of the loss, so its SSIM terms are computed in every
    call, as in bench.py."""
    res = render(cam, model.replace(params=params), cfg, t=t,
                 bg=torch.zeros(3, device=gt.device), capacity=capacity,
                 kernel_cfg=kernel_cfg, device=gt.device)
    img = res.render
    return 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))


def fwd_bwd_tick(scene: BenchScene, gt: torch.Tensor, kernel_cfg: KernelConfig | None):
    """tick(i): the gradient of `fwd_bwd_loss` at t = i % 5 with respect
    to every parameter, on gt's device, the parameters made leaves once
    (as train_step makes them)."""
    params = {k: v.detach().requires_grad_(True) for k, v in scene.model.params.items()}

    def tick(i):
        loss = fwd_bwd_loss(params, scene.model, scene.cfg, scene.cam, float(i % 5), gt,
                            kernel_cfg, capacity=scene.capacity)
        return torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    return tick


def train_step_tick(scene: BenchScene, gt: torch.Tensor, kernel_cfg: KernelConfig | None,
                    device):
    """tick(i): bench.py:172-194's step, `train_step` at t = i % 5 and
    iteration 100 (spatial_lr_scale 3, the default OptimizationConfig, the
    scene's capacity, black background) on a copy of the scene's model and
    a fresh optimizer state: from that one state on the CPU; on CUDA, where
    train_step updates its state in place, carried from tick to tick.
    scene.model is left as it is."""
    dev = resolve_device(device)
    statics = StepStatics(cfg=scene.cfg, opt=OptimizationConfig(), spatial_lr_scale=3.0,
                          capacity=scene.capacity, kernel=kernel_cfg)
    model, state = clone_state(scene.model, init_state(scene.model.params, device=dev))
    bg = torch.zeros(3, device=dev)
    return lambda i: train_step(model, state, scene.cam, gt, float(i % 5), bg, 100, statics,
                                device=dev)


def render_tick(scene: BenchScene, track_idx: bool, kernel_cfg: KernelConfig | None, device):
    """tick(i): the render at t = i % 5 (black background, the scene's
    capacity), with or without the dominant-index bookkeeping."""
    dev = resolve_device(device)
    bg = torch.zeros(3, device=dev)

    def tick(i):
        with torch.no_grad():
            return render(scene.cam, scene.model, scene.cfg, t=float(i % 5), bg=bg,
                          capacity=scene.capacity, track_idx=track_idx,
                          kernel_cfg=kernel_cfg, device=dev).render

    return tick


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them, or its
    name from torch where nvidia-smi is absent."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except FileNotFoundError:
        return torch.cuda.get_device_name(0)
    return out.stdout.strip().splitlines()[0]


def kernel_ms(scene: BenchScene, kcfg: KernelConfig) -> tuple[float, float]:
    """(kernel A ms, kernel B ms) per launch on the scene's frame at t = 1
    packed at kcfg, B on seeded cotangents: CUDA events over 20 launches
    after 2 warm-ups, as chip_smoke.py's kernels phase times them."""
    f = pack_frame(scene, kcfg.tile_x, kcfg.tile_y, kcfg.tight_cull, exact_sort=kcfg.exact_sort)
    kw = dict(grid_x=f.grid_x, tile_x=kcfg.tile_x, tile_y=kcfg.tile_y)
    accum, tfinal, _ = kernels.composite_fwd(f.data, f.gid, f.starts, f.stops, track_idx=True,
                                             **kw)
    ms_a = cuda_ms(lambda: kernels.composite_fwd(f.data, f.gid, f.starts, f.stops,
                                                 track_idx=True, **kw), reps=20)
    bargs = (f.data, f.starts, f.stops, *cotangents(accum), tfinal)
    ms_b = cuda_ms(lambda: kernels.composite_bwd(*bargs, **kw), reps=20)
    return ms_a, ms_b


def launches_of(tick, device) -> dict:
    """The compositing kernels' launches in one call of tick."""
    before = dict(kernels.launches)
    tick(0)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {k: kernels.launches[k] - before[k] for k in KERNELS}


def run(device=None) -> dict:
    """The bench on `device` (cuda unless told otherwise) at the sizes of
    `settings_from_env`. Returns the JSON line's object."""
    dev = resolve_device(device)
    s = settings_from_env()
    kcfg = KernelConfig.from_env()
    kernels.reset_launches()
    scene = bench_scene(dev, width=s["width"], height=s["height"], n_static=s["n_static"],
                        n_dynamic=s["n_dynamic"], probe_capacity=s["probe_capacity"],
                        kernel_cfg=kcfg)
    if scene.total > scene.capacity:
        raise RuntimeError(f"bench scene overflows the binning capacity ({scene.total} > "
                           f"{scene.capacity}); raise BENCH_CAPACITY")
    print(f"# instances per frame: {scene.total} (capacity {scene.capacity}); "
          f"kernel config {kcfg.to_json()}", flush=True)
    W, H = scene.cam.width, scene.cam.height
    gt = torch.zeros((H, W, 3), device=dev)
    ticks = {"fwd_bwd": fwd_bwd_tick(scene, gt, kcfg)}
    if s["train_step"]:
        ticks["train_step"] = train_step_tick(scene, gt, kcfg, dev)
    ticks["render"] = render_tick(scene, True, kcfg, dev)
    ticks["render_noidx"] = render_tick(scene, False, kcfg, dev)
    ms, per_call = {}, {}
    for name, tick in ticks.items():
        per_call[name] = launches_of(tick, dev)
        timing = measure(tick, s["iters"], s["repeats"], dev)
        ms[name] = timing.ms
        print(f"# {name}: {timing.ms:.3f} ms/call, windows "
              + ", ".join(f"{w:.3f}" for w in timing.windows_ms), flush=True)

    def mpix_s(name):
        return W * H / ms[name] / 1e3 if name in ms else None

    composite, card_name = (None, None), None
    if dev.type == "cuda":
        composite = kernel_ms(scene, kcfg)
        card_name = card()
    return {
        "metric": "rasterizer_fwd_bwd_throughput",
        "value": mpix_s("fwd_bwd"),
        "unit": "Mpixels/s/chip",
        "vs_baseline": mpix_s("fwd_bwd") / BASELINE_MPIX_S,
        "train_step_mpix_s": mpix_s("train_step"),
        "render_mpix_s": mpix_s("render"),
        "render_noidx_mpix_s": mpix_s("render_noidx"),
        "instances": scene.total,
        "capacity": scene.capacity,
        "resolution": [W, H],
        "kernel_config": json.loads(kcfg.to_json()),
        "fwd_bwd_ms": ms["fwd_bwd"],
        "train_step_ms": ms.get("train_step"),
        "render_ms": ms["render"],
        "render_noidx_ms": ms["render_noidx"],
        "composite_fwd_ms": composite[0],
        "composite_bwd_ms": composite[1],
        "launches": {**per_call, "run": {k: kernels.launches[k] for k in KERNELS}},
        "card": card_name,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def main(device=None, argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m ex4dgs_tpu_torch.bench")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to measure on (default cuda)")
    args = parser.parse_args(argv)
    out = run(device or args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
