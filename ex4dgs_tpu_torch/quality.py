"""The at-scale quality run: train a synthetic 4D capture to convergence and
measure the held-out camera.

    python -m ex4dgs_tpu_torch.quality [--iters N] [--target surface|dust]
        [--soft] [--no_extract] [--sh D] [--preset full|repro] [--out DIR]
        [--device cpu]

The port of `tools/tpu_probes/_tpu_quality2.py` (its environment knobs are
flags: Q2_ITERS --iters, Q2_TARGET --target, Q2_SOFT=1 --soft,
Q2_EXTRACT=0 --no_extract, Q2_SH --sh; its /tmp paths live under --out):

1. the target: `synthetic.make_surface_scene` (50k static + 5k dynamic
   splats, seed 7) seen by a 19-camera two-elevation rig at 800x600, or
   with --target dust the volumetric cloud of `make_scene` (opacity 0.85)
   on a 10-camera ring;
2. ground truth: every camera at t = 0..7 rendered by `rendering.render`
   (kernel A on the card) and saved as 8-bit PNG; camera 0 is the held-out
   split (the N3V cam00 analog), the other cameras train;
3. the initial cloud: the target's active rows at t = 0 plus N(0, 0.02)
   noise (numpy seed 0), coloured by their SH DC, with scales clamped to
   log(0.03);
4. training: the reference-shaped full schedule (densify, static->dynamic
   extraction, progressive duration growth from 2 to 8 timestamps; or the
   softened one with --soft) for --iters iterations (3000) with the
   held-out PSNR every 250 and a metrics JSONL every 50, then a save;
5. the held-out metrics: PSNR, SSIM and skimage SSIM of camera 0 at each
   timestamp, and the render FPS of camera 1 at t = 1 at the snug capacity
   (`round_capacity(total * 5 // 4, 65536)` from one probe render): 50
   warm-up renders, then 500 timed, each ending in
   `torch.cuda.synchronize()`.

The last line is the script's `SUMMARY {json}` with its keys, plus the
PSNR per timestamp, the held-out trajectory, the host-clock ms per
iteration (with and without the event iterations) and the compositing
kernels' launches by stage.

--preset repro takes the sizes and cadences of
`tools/tpu_probes/_cpu_surface_repro.py` (280x210, 6000 + 600 splats,
capacity 256k, its schedule scaled to --iters, default 1200, the held-out
PSNR every iters // 8): a run the CPU finishes. It measures no FPS.

The ground truth is rendered on every run (the script reuses PNGs it finds
on disk). The port's Trainer has no `max_per_tile` or `backend`: the card
always composites with the kernels.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time

import numpy as np
import torch

from . import kernels, resolve_device
from .data.cameras import CameraInfo
from .data.readers import PointCloud, SceneInfo
from .data.scene import Scene
from .eval.metrics import ssim as ssim_torch
from .eval.metrics import ssim_skimage
from .models.config import ModelConfig, OptimizationConfig
from .models.state import create_from_pcd, round_capacity
from .models.temporal import point_data_at_t
from .ops.losses import psnr
from .ops.math3d import sh0_to_rgb
from .rendering import render
from .synthetic import make_scene, make_surface_scene, rig_cameras, ring_cameras
from .train.trainer import Trainer

N_T = 8
FOV = math.radians(60)
FPS_WARMUP, FPS_RENDERS = 50, 500
# _tpu_quality2.py:33-36 and _cpu_surface_repro.py:26-35 (cameras: 19 on the
# surface target's rig, 10 on the dust target's ring, unless n_cams is set)
PRESETS = {
    "full": dict(width=800, height=600, n_static=50_000, n_dynamic=5_000,
                 static_capacity=65_536, dynamic_capacity=8_192, capacity=1024 * 1024,
                 iters=3000, fps=True),
    "repro": dict(width=280, height=210, n_static=6_000, n_dynamic=600, static_capacity=8192,
                  dynamic_capacity=1024, capacity=256 * 1024, iters=1200, fps=False),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m ex4dgs_tpu_torch.quality")
    p.add_argument("--iters", type=int, default=None,
                   help="training iterations (the preset's: 3000 full, 1200 repro)")
    p.add_argument("--target", choices=("surface", "dust"), default="surface")
    p.add_argument("--soft", action="store_true", help="the softened round-2 schedule")
    p.add_argument("--no_extract", action="store_true",
                   help="disable static->dynamic extraction (both triggers)")
    p.add_argument("--sh", type=int, default=3, help="SH degree")
    p.add_argument("--preset", choices=tuple(PRESETS), default="full")
    p.add_argument("--out", type=str, default=None,
                   help="directory of the frames, the metrics JSONL and the model "
                        "(default output/quality_<target>)")
    p.add_argument("--device", type=str, default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.iters is None:
        args.iters = PRESETS[args.preset]["iters"]
    if args.out is None:
        args.out = os.path.join("output", f"quality_{args.target}")
    return args


def model_config(soft: bool = False, sh: int = 3) -> ModelConfig:
    """_tpu_quality2.py:47-53 (the repro script's with soft=False)."""
    return ModelConfig(time_interval=2, time_pad=1, start_duration=8 if soft else 2,
                       duration=8, near=0.2, far=50.0, resolution=1, sh_degree=sh)


def build_target(cfg: ModelConfig, target: str, preset: str, device=None):
    """(target model, cameras) of _tpu_quality2.py:54-67 at the preset's
    size."""
    pr = PRESETS[preset]
    kw = dict(n_static=pr["n_static"], n_dynamic=pr["n_dynamic"], duration=8.0, seed=7,
              static_capacity=pr["static_capacity"],
              dynamic_capacity=pr["dynamic_capacity"], cfg=cfg, device=device)
    if target == "surface":
        model, _ = make_surface_scene(**kw)
        cams = rig_cameras(pr.get("n_cams", 19), 3.0, pr["width"], pr["height"], far=cfg.far,
                           device=device)
    else:
        model, _ = make_scene(opacity=0.85, **kw)
        cams = ring_cameras(pr.get("n_cams", 10), 3.0, pr["width"], pr["height"], far=cfg.far,
                            device=device)
    return model, cams


def render_ground_truth(target_model, cams, cfg: ModelConfig, out_dir: str, capacity: int,
                        device=None) -> list[CameraInfo]:
    """Every camera at t = 0..N_T-1 rendered, clipped and saved as 8-bit PNG
    (_tpu_quality2.py:69-88): the CameraInfos, camera-major. Raises if a
    frame overflows the capacity."""
    from PIL import Image

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    infos = []
    with torch.no_grad():
        for ci, cam in enumerate(cams):
            view = cam.view.cpu().numpy()
            for t in range(N_T):
                path = os.path.join(out_dir, f"c{ci}_t{t}.png")
                res = render(cam, target_model, cfg, t=float(t),
                             bg=torch.zeros(3, device=dev), capacity=capacity, device=dev)
                if int(res.binning_total) > capacity:
                    raise RuntimeError(f"ground truth c{ci} t{t}: {int(res.binning_total)} "
                                       f"instances overflow capacity {capacity}")
                img = torch.clamp(res.render, 0, 1).cpu().numpy()
                Image.fromarray((img * 255).astype(np.uint8)).save(path)
                infos.append(CameraInfo(
                    uid=ci, R=view[:3, :3].T, T=view[:3, 3], fovx=FOV, fovy=FOV,
                    image_path=path, image_name=f"c{ci}_t{t}.png", width=cam.width,
                    height=cam.height, near=cfg.near, far=cfg.far, timestamp=float(t)))
    return infos


def split(infos: list[CameraInfo]) -> tuple[list, list]:
    """(train, test): camera 0 is held out (_tpu_quality2.py:90-92)."""
    test = [i for i in infos if i.uid == 0]
    train = [i for i in infos if i.uid != 0]
    assert test and all(i.uid != 0 for i in train)
    return train, test


def initial_cloud(target_model, cfg: ModelConfig):
    """(points, colours) of _tpu_quality2.py:108-113: the target's active
    rows at t = 0 plus seeded N(0, 0.02) noise, coloured by their SH DC."""
    rng = np.random.default_rng(0)
    with torch.no_grad():
        pd0 = point_data_at_t(target_model, cfg, 0.0, mode=0)
        act = pd0.mask.cpu().numpy()
        pts0 = pd0.means3d.cpu().numpy()[act] + rng.normal(
            scale=0.02, size=(int(act.sum()), 3)).astype(np.float32)
        cols0 = np.clip(sh0_to_rgb(pd0.features[act][:, 0]).cpu().numpy(), 0, 1)
    return pts0, cols0


def initial_model(pts0, cols0, cfg: ModelConfig, device=None):
    """create_from_pcd with the scales clamped to log(0.03)
    (_tpu_quality2.py:114-119)."""
    model = create_from_pcd(pts0, cols0, cfg, duration=max(cfg.start_duration, 1), device=device)
    model.params["scaling"] = torch.clamp_max(model.params["scaling"], math.log(0.03))
    return model


def optimization(iters: int, preset: str = "full", soft: bool = False,
                 extract: bool = True) -> OptimizationConfig:
    """The schedule: _tpu_quality2.py:121-151 (full), :152-165 (soft), or
    _cpu_surface_repro.py:74-86 (the repro preset). Without `extract` both
    extraction triggers are off and extract_from_iter still gates growth."""
    base = dict(iterations=iters, position_lr_init=0.0016, position_lr_final=0.00016,
                feature_lr=0.025, opacity_lr=0.05, scaling_lr=0.005, disp_lr=0.001,
                prune_invisible_interval=10_000, random_background=False, static_reg=0.0)
    if soft:
        return OptimizationConfig(
            densification_interval=100, densify_from_iter=100,
            densify_until_iter=int(iters * 0.6), densify_grad_threshold=0.0008,
            densify_dgrad_threshold=0.0004, extract_from_iter=200, extracton_interval=250,
            progressive_growing_steps=100000, make_dynamic_interval=50, **base)
    if preset == "repro":
        extraction = (dict(extracton_interval=max(1, iters // 10)) if extract
                      else dict(extracton_interval=iters + 1, extract_every=10**5))
        return OptimizationConfig(
            densification_interval=iters * 300 // 4000, densify_from_iter=iters * 500 // 4000,
            densify_until_iter=int(iters * 0.75), extract_from_iter=iters * 500 // 4000,
            progressive_growing_steps=max(1, iters // 10),
            make_dynamic_interval=max(1, iters // 40), **extraction, **base)
    return OptimizationConfig(
        densification_interval=300, densify_from_iter=500, densify_until_iter=int(iters * 0.75),
        extract_from_iter=500, extracton_interval=max(1, iters // 10) if extract else iters + 1,
        # the off value keeps progressive_growing_steps * extract_every in int32
        extract_every=1 if extract else 10**5, progressive_growing_steps=max(1, iters // 10),
        make_dynamic_interval=100, **base)


def held_out_iterations(iters: int, preset: str) -> tuple:
    """The iterations of the held-out PSNR trajectory."""
    if preset == "repro":
        step = max(1, iters // 8)
        return tuple(range(step, iters + 1, step))
    return tuple(range(250, iters + 1, 250))


def _k(n: int) -> str:
    return f"{n // 1000}k" if n % 1000 == 0 else str(n)


def _launches() -> dict:
    return {k: v for k, v in kernels.launches.items() if v}


def run(args: argparse.Namespace) -> dict:
    """The whole run. Returns {"summary": the SUMMARY object (the script's
    keys first, _tpu_quality2.py:228-242), "trainer" (closed), "cfg",
    "rows" (per held-out frame), "stages" (host seconds and kernel launches
    of each stage)}."""
    dev = resolve_device(args.device)
    pr = PRESETS[args.preset]
    W, H = pr["width"], pr["height"]
    capacity = pr["capacity"]
    cfg = model_config(args.soft, args.sh)
    stages = {}

    def stage(name, t0, before):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = _launches()
        stages[name] = {"s": time.perf_counter() - t0,
                        "launches": {k: v - before.get(k, 0) for k, v in now.items()
                                     if v - before.get(k, 0)}}
        return time.perf_counter(), now

    kernels.reset_launches()
    t0, seen = time.perf_counter(), {}
    target_model, cams = build_target(cfg, args.target, args.preset, dev)
    infos = render_ground_truth(target_model, cams, cfg, os.path.join(args.out, "frames"),
                                capacity, dev)
    train_infos, test_infos = split(infos)
    t0, seen = stage("ground_truth", t0, seen)

    pts0, cols0 = initial_cloud(target_model, cfg)
    del target_model
    init_model = initial_model(pts0, cols0, cfg, dev)
    opt = optimization(args.iters, args.preset, args.soft, not args.no_extract)
    info = SceneInfo(point_cloud=PointCloud(pts0, cols0), train_cameras=train_infos,
                     test_cameras=test_infos,
                     nerf_normalization={"translate": np.zeros(3), "radius": 3.0}, ply_path="")
    scene = Scene(cfg, scene_info=info)
    tr = Trainer(cfg, opt, scene, model=init_model, capacity=capacity, seed=1,
                 test_iterations=held_out_iterations(args.iters, args.preset),
                 metrics_path=os.path.join(args.out, "metrics.jsonl"), log_every=50, device=dev)
    t0, seen = stage("setup", t0, seen)
    try:
        metrics = tr.train(iterations=args.iters)
    finally:
        tr.close()
    wall = metrics["wall_time"]
    t0, seen = stage("train", t0, seen)
    tr.save(os.path.join(args.out, "model"))
    t0, seen = stage("save", t0, seen)

    from PIL import Image

    rows = []
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        for inf in test_infos:
            gt = np.asarray(Image.open(inf.image_path), np.float32)[..., :3] / 255.0
            res = render(cams[inf.uid], tr.model, cfg, t=inf.timestamp, bg=bg,
                         capacity=tr.capacity, device=dev)
            if int(res.binning_total) > tr.capacity:
                raise RuntimeError(f"held-out {inf.image_name}: {int(res.binning_total)} "
                                   f"instances overflow capacity {tr.capacity}")
            img_t = torch.clamp(res.render, 0, 1)
            gt_t = torch.from_numpy(gt).to(dev)
            img = img_t.cpu().numpy()
            rows.append({"name": inf.image_name, "t": inf.timestamp,
                         "psnr": float(psnr(img_t, gt_t)), "ssim": ssim_torch(img_t, gt_t),
                         "ssim_sk": ssim_skimage(img, gt)})
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(args.out, f"render_{inf.image_name}"))
    t0, seen = stage("held_out", t0, seen)

    fps = rcap = None
    if pr["fps"]:
        with torch.no_grad():
            probe = render(cams[1], tr.model, cfg, t=1.0, bg=bg, capacity=tr.capacity,
                           device=dev)
            rcap = min(capacity, round_capacity(int(probe.binning_total) * 5 // 4, 65536))
            t0, seen = stage("fps_probe", t0, seen)

            def frame():
                render(cams[1], tr.model, cfg, t=1.0, bg=bg, capacity=rcap, device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

            for _ in range(FPS_WARMUP):
                frame()
            tf = time.perf_counter()
            for _ in range(FPS_RENDERS):
                frame()
            fps = FPS_RENDERS / (time.perf_counter() - tf)
        t0, seen = stage("fps", t0, seen)

    iter_ms = metrics["iter_ms"]
    events = set(metrics["event_iterations"])
    quiet = [ms for i, ms in enumerate(iter_ms, 1) if i not in events]
    summary = {
        "config": f"{'2' if args.preset == 'full' else args.preset}. {_k(pr['n_static'])} "
                  f"static + {_k(pr['n_dynamic'])} dynamic, {N_T} timesteps, {W}x{H}",
        "target": args.target,
        "n_cams": len(cams),
        "iters": args.iters,
        "psnr": float(np.mean([r["psnr"] for r in rows])),
        "ssim": float(np.mean([r["ssim"] for r in rows])),
        "ssim_sk": float(np.mean([r["ssim_sk"] for r in rows])),
        "train_wall_s": round(wall, 1),
        "train_mpix_s": round(args.iters * W * H / wall / 1e6, 2),
        "render_fps": None if fps is None else round(fps, 1),
        "render_mpix_s": None if fps is None else round(fps * W * H / 1e6, 1),
        "n_static": int(tr.model.n_static()),
        "n_dynamic": int(tr.model.n_dynamic()),
        "psnr_by_t": {f"{r['t']:g}": r["psnr"] for r in rows},
        "test_psnr": [[it, rep.get("psnr")] for it, rep in metrics.get("test_reports", [])],
        "ms_per_iteration": statistics.mean(iter_ms),
        "ms_per_iteration_without_events": statistics.mean(quiet) if quiet else None,
        "event_iterations": len(events),
        "overflow_retries": tr.overflow_count,
        "capacity": tr.capacity,
        "render_capacity": rcap,
        "decoder": tr.prefetcher.decoder,
        "device": str(dev),
        "preset": args.preset,
        "kernel_launches": {name: st["launches"] for name, st in stages.items()},
    }
    losses = np.asarray(metrics["loss"])
    summary["loss_finite"] = bool(np.isfinite(losses).all())
    return {"summary": summary, "trainer": tr, "cfg": cfg, "rows": rows, "stages": stages}


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    for r in out["rows"]:
        print(json.dumps(r), flush=True)
    s = out["summary"]
    print("held-out PSNR by timestamp: " + ", ".join(
        f"t={t} {v:.2f}" for t, v in s["psnr_by_t"].items()), flush=True)
    print("held-out PSNR trajectory: " + ", ".join(
        f"{it} {v:.2f}" for it, v in s["test_psnr"]), flush=True)
    print("SUMMARY " + json.dumps(s), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
