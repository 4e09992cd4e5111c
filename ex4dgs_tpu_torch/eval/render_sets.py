"""Offline render + metric harness — the reference's render.py:35-161.

Counterpart of `ex4dgs_tpu/eval/render_sets.py`: renders the train or test
cameras of a trained model at their timestamps, computes PSNR/SSIM/LPIPS
per frame, measures render FPS with the reference's timing recipe (rounds
of per-call renders, each ending in `torch.cuda.synchronize()`, warm-up
calls dropped, render.py:91-96) and writes mean_metrics.json,
all_metrics.json and all_metrics_rows.json with the reference's key names.

Two differences from the JAX harness, both in what it renders, not in what
it reports: there is no `max_per_tile` (the port's kernels walk each tile's
true length), and a metric render whose instances overflow the capacity is
rendered again at a grown capacity (the trainer's rule), so no metric comes
from a truncated instance list.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.scene import Scene, load_image
from ..kernel_config import KernelConfig
from ..models.config import ModelConfig
from ..models.state import GaussianModel, round_capacity
from ..rendering import default_capacity, render
from . import metrics as M

# The reference's mean_metrics.json key names (render.py:98-106), so a
# reference user's tooling reads these JSONs unchanged.
_REF_KEYS = {"SSIM": "ssim", "SKSSIM": "ssim_sk", "SKSSIM2": "ssim_sk2", "PSNR": "psnr",
             "LPIPS": "lpips_alex", "LPIPSVGG": "lpips_vgg"}


def render_set(model: GaussianModel, cfg: ModelConfig, scene: Scene, split: str,
               out_dir: str | None = None, *, capacity: int | None = None,
               save_images: bool = False, measure_fps: bool = True,
               lpips_nets: tuple = ("alex", "vgg"), fps_rounds: int = 20,
               fps_inner: int = 500, fps_warmup: int = 100, timings: dict | None = None,
               kernel_cfg: KernelConfig | None = None, device=None) -> dict:
    """Evaluate one split on `device` (cuda unless told otherwise; the model
    must be there). Returns the JAX harness's result dict. Every render of
    the call (metric frames, their re-renders at a grown capacity, the FPS
    recipe's probe and timed calls) and the default capacity take
    `kernel_cfg`, by default `KernelConfig.from_env()` read once per call,
    as the JAX harness renders with its environment's config. `timings`, when
    given, is filled with what the reference's JSONs do not hold: the
    config rendered with, the metric renders' capacity and overflow retries, the snug capacity, the
    host ms per frame of each stage (render, GT load, PSNR+SSIM,
    ssim_skimage at data range 1 and 2, each LPIPS net) and the FPS
    recipe's ms per call at the metric renders' capacity (one round)."""
    dev = resolve_device(device)
    kcfg = kernel_cfg or KernelConfig.from_env()
    if timings is not None:
        timings["kernel_config"] = json.loads(kcfg.to_json())
    cams = (scene.sampled_test_cameras() if split == "test"
            else scene.sampled_train_cameras())
    if not cams:
        return {"split": split, "n_frames": 0}
    if capacity is None:
        capacity = default_capacity(model.static_capacity + model.dynamic_capacity,
                                    cams[0].width, cams[0].height, kcfg)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0], device=dev)
    lpips = {n: M.LPIPS(n, device=dev) for n in lpips_nets}
    stages = {k: [] for k in ("render", "gt_load", "psnr_ssim", "ssim_sk", "ssim_sk2",
                              *(f"lpips_{n}" for n in lpips_nets))}
    retries = 0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def frame(cam, t, cap):
        return render(cam, model, cfg, t=t, bg=bg, capacity=cap, kernel_cfg=kcfg, device=dev)

    def clock(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        stages[stage].append((time.perf_counter() - t0) * 1e3)
        return out

    rows = []
    if out_dir and save_images:
        os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "gt"), exist_ok=True)

    with torch.no_grad():
        for i, cam in enumerate(cams):
            rc = cam.render_camera(dev)
            res = clock("render", lambda: frame(rc, cam.timestamp, capacity))
            total = int(res.binning_total)
            while total > capacity:
                retries += 1
                capacity = round_capacity(max(total * 5 // 4, capacity * 2), 65536)
                res = frame(rc, cam.timestamp, capacity)
                total = int(res.binning_total)
            img = torch.clamp(res.render, 0.0, 1.0)
            gt_np = clock("gt_load", lambda: load_image(cam.image_path, (cam.width, cam.height),
                                                        cam.im_scale))
            gt = torch.from_numpy(gt_np).to(dev)
            img_np = img.cpu().numpy()
            p, s = clock("psnr_ssim", lambda: (M.psnr(img, gt), M.ssim(img, gt)))
            row = {
                "frame": cam.image_name,
                "timestamp": cam.timestamp,
                "psnr": p,
                "ssim": s,
                "ssim_sk": clock("ssim_sk", lambda: M.ssim_skimage(img_np, gt_np)),
                # the reference's second skimage variant uses data_range=2
                # (render.py:79) — kept for metric-for-metric comparability
                "ssim_sk2": clock("ssim_sk2", lambda: M.ssim_skimage(img_np, gt_np,
                                                                     data_range=2.0)),
            }
            for n, fn in lpips.items():
                row[f"lpips_{n}"] = clock(f"lpips_{n}", lambda: fn(img, gt))
            rows.append(row)
            if out_dir and save_images:
                from PIL import Image

                Image.fromarray((img_np * 255).astype(np.uint8)).save(
                    os.path.join(out_dir, "renders", f"{i:05d}.png"))
                Image.fromarray((gt_np * 255).astype(np.uint8)).save(
                    os.path.join(out_dir, "gt", f"{i:05d}.png"))

        result = {"split": split, "n_frames": len(rows)}
        for key in ("psnr", "ssim", "ssim_sk", "ssim_sk2", "lpips_alex", "lpips_vgg"):
            vals = [r[key] for r in rows if r.get(key) is not None]
            if vals:
                result[key] = float(np.mean(vals))
        for ref_k, ours_k in _REF_KEYS.items():
            if ours_k in result:
                result[ref_k] = result[ours_k]

        if timings is not None:
            timings.update(capacity=capacity, overflow_retries=retries, stage_ms=stages)
        if measure_fps:
            rc = cams[0].render_camera(dev)
            t = cams[0].timestamp
            # Render-time buffers sized to the actual instance count, as the
            # reference allocates per num_rendered (rasterizer_impl.cu:298-299):
            # every capacity-shaped op (expand, sort, pack) would tax each
            # frame at the training capacity.
            probe = frame(rc, t, capacity)
            snug = min(capacity, round_capacity(int(probe.binning_total) * 5 // 4, 65536))
            # The reference recipe (render.py:91-96): rounds of renders, each
            # call timed alone and ending in a synchronize (its render
            # synchronizes per call, gaussian_renderer/__init__.py:111), the
            # calls up to the warm-up index of each round dropped.
            warm = fps_warmup if fps_inner > fps_warmup else fps_inner // 2

            def recipe(cap, rounds):
                times = []
                for _ in range(rounds):
                    for idx in range(fps_inner):
                        t0 = time.perf_counter()
                        frame(rc, t, cap)
                        sync()
                        if idx > warm:
                            times.append(time.perf_counter() - t0)
                return float(np.mean(times))

            mean_s = recipe(snug, fps_rounds)
            # "times" is the reference's mean_metrics.json key (render.py:105)
            result["times"] = mean_s
            result["render_time_s"] = mean_s
            result["fps"] = float(1.0 / mean_s)
            result["mpixels_per_s"] = float(cams[0].width * cams[0].height / mean_s / 1e6)
            if timings is not None:
                timings.update(snug_capacity=snug, fps_ms=mean_s * 1e3,
                               fps_ms_at_capacity=recipe(capacity, 1) * 1e3)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # all_metrics.json in the reference's per-view layout
        # ({METRIC: {image_name: value}}, render.py:111-121); the richer
        # per-frame row list goes to all_metrics_rows.json.
        per_view = {}
        for ref_k, ours_k in _REF_KEYS.items():
            vals = {r["frame"]: r[ours_k] for r in rows if r.get(ours_k) is not None}
            if vals:
                per_view[ref_k] = vals
        with open(os.path.join(out_dir, "all_metrics.json"), "w") as f:
            json.dump(per_view, f, indent=1)
        with open(os.path.join(out_dir, "all_metrics_rows.json"), "w") as f:
            json.dump(rows, f, indent=1)
        with open(os.path.join(out_dir, "mean_metrics.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result
