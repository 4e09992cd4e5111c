"""The training loop: the reference's train.py:42-282 around the port's
`train_step`.

Counterpart of `ex4dgs_tpu/train/trainer.py`, run serially: every
iteration reads its loss and instance count on the host before the next
one starts, as the JAX loop does with `EX4DGS_PIPELINE=0` (the port's step
reads `binning_total` on the host anyway, so a one-step pipeline would
hide nothing). So a binning overflow and the NaN flag are acted on in the
iteration that raised them, and the events see exactly the reference's
order.

Division of labor:
  * every-step work (render, loss, backward, RAdam, stat accumulation) is
    one `train_step`, which launches the compositing kernels A and B once
    each on the card;
  * rare events (densify/prune/extract/expand, checkpoints) pull the state
    to the host (models/density.py), run in numpy, and push it back with
    bucketed capacities; `_scheduled_events` is the one copy of the
    schedule: it runs the events due at an iteration and returns their
    names;
  * frames stream through a threaded prefetcher whose decoded frames stay
    on the device.

The RNG order is the JAX trainer's: `rng` (numpy) draws the random
background once per iteration and the density events' randomness,
`pyrng` (random.Random) shuffles each epoch, so one seed gives both
trainers the same cameras, backgrounds and event randomness.
"""
from __future__ import annotations

import os
import random
import time
import warnings

import numpy as np
import torch

from .. import resolve_device
from ..data.scene import ImagePrefetcher, Scene
from ..io.checkpoint import save_checkpoint
from ..io.model_ply import save_model_ply
from ..kernel_config import KernelConfig
from ..models import density as D
from ..models.config import ModelConfig, OptimizationConfig
from ..models.optimizer import RAdamState, init_state
from ..models.state import (GaussianModel, create_from_pcd, oneup_sh_degree, required_keyframes,
                            round_capacity)
from ..ops.losses import psnr as psnr_fn
from ..rendering import default_capacity, render
from .step import StepStatics, train_step

OVERFLOW_RETRIES = 4
LOG_EVERY = 50  # iterations between progress callbacks


class ErrorTracker:
    """Per-timestamp-window loss bookkeeping (the reference's
    c_gaussian_model.py:1299-1328)."""

    def __init__(self, interval: int):
        self.interval = interval
        self.errors: dict[int, tuple[float, int]] = {}

    def mark(self, loss: float, timestamp: float) -> None:
        t_idx = int(timestamp // self.interval)
        s, c = self.errors.get(t_idx, (0.0, 0))
        self.errors[t_idx] = (s + loss, c + 1)

    def pop_worst(self):
        if not self.errors:
            return None
        max_count = max(c for _, c in self.errors.values())
        best_idx, best_loss = None, 0.0
        for t_idx, (s, c) in self.errors.items():
            if s / c > best_loss and c > max_count * 0.1:
                best_loss = s / c
                best_idx = t_idx
        if best_idx is None or best_loss == 0.0:
            return None
        del self.errors[best_idx]
        return (best_idx + 0.5) * self.interval


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Trainer:
    """Trains one model on one scene on `device` (cuda unless told
    otherwise).

    Counters a run leaves behind: `event_counts` and `event_ms` (per event
    kind, host clock of the event's numpy work), `pull_ms`/`push_ms` (every
    event's transfers), `event_log` ((iteration, kind, n_static,
    n_dynamic) after each event), `overflow_count` (retries after a binning
    overflow), `test_renders` and `steps` (train_step calls, retries
    included), `gui_renders` (viewer requests served)."""

    def __init__(self, cfg: ModelConfig, opt: OptimizationConfig, scene: Scene,
                 model: GaussianModel | None = None, opt_state: RAdamState | None = None,
                 seed: int = 0, capacity: int | None = None,
                 test_iterations: tuple = (), kernel: KernelConfig | None = None,
                 debug_snapshot_dir: str | None = None, gui=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.opt = opt
        self.scene = scene
        self.rng = np.random.default_rng(seed)
        self.pyrng = random.Random(seed)
        self.kernel = (kernel or KernelConfig()).validate()

        if model is None:
            pc = scene.info.point_cloud
            model = create_from_pcd(pc.points, pc.colors, cfg,
                                    duration=max(cfg.start_duration, 1), device=self.device)
        self.model = model
        self.opt_state = (opt_state if opt_state is not None
                          else init_state(model.params, device=self.device))
        self.error_tracker = ErrorTracker(cfg.time_interval)
        self.prefetcher = ImagePrefetcher(device=self.device)

        cam0 = scene.train_cameras[0] if scene.train_cameras else None
        w = cam0.width if cam0 else 128
        h = cam0.height if cam0 else 128
        n_pts = model.static_capacity + model.dynamic_capacity
        self.capacity = capacity or default_capacity(n_pts, w, h, self.kernel)
        self.test_iterations = set(test_iterations)
        self.debug_snapshot_dir = debug_snapshot_dir
        # Optional live network viewer (viewer.NetworkViewer), polled before
        # every step like the reference's network_gui hook (train.py:93-106).
        self.gui = gui

        self.overflow_count = 0
        self.test_renders = 0
        self.gui_renders = 0
        self.steps = 0
        self.event_counts: dict[str, int] = {}
        self.event_ms: dict[str, list[float]] = {}
        self.pull_ms: list[float] = []
        self.push_ms: list[float] = []
        self.event_log: list[tuple[int, str, int, int]] = []

        # schedule state (train.py:77-86)
        self.sample_len = float(cfg.start_duration)
        self.mark_extract = False
        self.need_extract = True
        self.mark_last = False
        self.prune_inv = False
        self.e_count = opt.extract_every
        self.iteration = 0
        self.last_vis: torch.Tensor | None = None
        self.last_cam = None

        scene.apply_timepad(cfg.time_pad, cfg.time_pad_type)
        scene.set_sampling_len(cfg.start_duration, sample_every=cfg.sample_every)
        # Keyframe capacity for the FULL scene duration up front, as the JAX
        # trainer sizes it, so that progressive growth never reshapes the
        # motion arrays and checkpoints compare row for row with JAX's.
        self._kf_floor = required_keyframes(scene.duration + cfg.time_shift, cfg)
        self._host_event("expand_duration",
                         lambda hm: D.expand_duration(hm, cfg, cfg.start_duration))

    def close(self) -> None:
        self.prefetcher.close()

    # ------------------------------------------------------------------
    def _statics(self) -> StepStatics:
        return StepStatics(cfg=self.cfg, opt=self.opt,
                           spatial_lr_scale=self.scene.cameras_extent,
                           capacity=self.capacity, kernel=self.kernel)

    def _host_event(self, kind: str, fn):
        """Pull -> mutate on the host -> push with bucketed capacities;
        returns what `fn` returned.

        The JAX trainer's capacity policy: static capacity grows
        GEOMETRICALLY (at least 2x) when exceeded and shrinks when fewer
        than a quarter of its rows are active; dynamic capacity is rounded
        to 1024; keyframe capacity is pre-allocated for the full scene
        duration at construction (padding keyframes are masked by
        keyframe_num exactly like padding rows)."""
        dev = self.device
        t0 = time.perf_counter()
        hm = D.pull(self.model, self.opt_state)
        t1 = time.perf_counter()
        result = fn(hm)
        t2 = time.perf_counter()
        sc = self.model.static_capacity
        if round_capacity(hm.n_static) > sc:
            sc = max(round_capacity(hm.n_static), round_capacity(2 * sc))
        if hm.n_static < self.model.static_capacity // 4:
            sc = round_capacity(hm.n_static)
        dc = self.model.dynamic_capacity
        if hm.n_dynamic > dc:
            dc = max(round_capacity(hm.n_dynamic, 1024),
                     round_capacity(2 * dc, 1024) if dc else 0)
        kf_needed = max(hm.keyframe_num, hm.params["motion_xyz"].shape[1], self._kf_floor)
        self.model, self.opt_state = D.push(hm, self.cfg, static_capacity=sc,
                                            dynamic_capacity=dc, keyframe_capacity=kf_needed,
                                            device=dev)
        _sync(dev)
        t3 = time.perf_counter()
        self.pull_ms.append((t1 - t0) * 1e3)
        self.push_ms.append((t3 - t2) * 1e3)
        self.event_counts[kind] = self.event_counts.get(kind, 0) + 1
        self.event_ms.setdefault(kind, []).append((t2 - t1) * 1e3)
        self.event_log.append((self.iteration, kind, hm.n_static, hm.n_dynamic))
        return result

    def _step(self, cam, gt, timestamp: float, bg, it: int):
        self.steps += 1
        return train_step(self.model, self.opt_state, cam, gt, timestamp, bg, it,
                          self._statics(), device=self.device)

    # ------------------------------------------------------------------
    def train(self, iterations: int | None = None, progress=None) -> dict:
        """Run the loop up to `iterations` (default opt.iterations).

        Returns {"loss", "psnr", "timestamps", "backgrounds", "iter_ms",
        "event_iterations"}: per iteration the loss, PSNR, camera timestamp,
        background and host-clock ms (step, retries, eval and events), and
        the iterations at which an event ran; plus "test_reports" and
        "wall_time"."""
        cfg, opt, dev = self.cfg, self.opt, self.device
        iterations = iterations or opt.iterations
        cam_iter = None
        bg_const_np = np.full(3, 1.0 if cfg.white_background else 0.0, np.float32)
        bg_const = torch.from_numpy(bg_const_np).to(dev)
        metrics = {"loss": [], "psnr": [], "timestamps": [], "backgrounds": [], "iter_ms": [],
                   "event_iterations": []}
        t_start = time.perf_counter()

        while self.iteration < iterations:
            t_it = time.perf_counter()
            self.iteration += 1
            it = self.iteration

            if self.gui is not None:
                # serve viewer requests between steps (train.py:93-106)
                self.gui.poll(self._gui_render, cfg.source_path or "",
                              training_active=self.iteration < iterations)

            if it % 1000 == 0:
                self.model = oneup_sh_degree(self.model, cfg.sh_degree)

            # next camera: a new shuffled epoch refills WITHIN the same
            # iteration, like the reference's viewpoint-stack pop
            # (train.py:117-125), so every iteration trains and no scheduled
            # event is skipped by an epoch boundary
            while True:
                if cam_iter is None:
                    cams = self.scene.sampled_train_cameras()
                    if not cams:
                        raise RuntimeError("no train cameras in sampling window")
                    cam_iter = self.prefetcher.epoch(cams, shuffle=True, rng=self.pyrng)
                    if it > opt.prune_invisible_interval:
                        self.prune_inv = True
                try:
                    cam, gt = next(cam_iter)
                    break
                except StopIteration:
                    cam_iter = None

            if self.mark_last and cam.timestamp >= self.sample_len - cfg.time_interval:
                self.mark_extract = True
                self.mark_last = False

            if opt.random_background:
                bg_np = self.rng.uniform(size=3).astype(np.float32)
                bg = torch.from_numpy(bg_np).to(dev)
            else:
                bg_np, bg = bg_const_np, bg_const
            cam_dev = cam.render_camera(dev)
            out = self._step(cam_dev, gt, cam.timestamp, bg, it)
            total = int(out.binning_total)
            if total > self.capacity:
                # The step left the state unchanged; grow the capacity and
                # re-run the same camera (the reference never trains on a
                # truncated instance list, rasterizer_impl.cu:298-299).
                for _attempt in range(OVERFLOW_RETRIES):
                    self.overflow_count += 1
                    self.capacity = round_capacity(max(total * 5 // 4, self.capacity * 2),
                                                   65536)
                    out = self._step(cam_dev, gt, cam.timestamp, bg, it)
                    total = int(out.binning_total)
                    if total <= self.capacity:
                        break
                else:
                    warnings.warn(
                        f"iteration {it}: binning overflow persisted through all "
                        f"capacity-growth retries (last total {total}); this step's update "
                        "was skipped and its logged metrics come from a truncated instance "
                        "list")
            self.model, self.opt_state = out.model, out.opt_state
            self.last_vis = out.visibility
            self.last_cam = cam

            loss = float(out.loss)
            self.error_tracker.mark(loss, cam.timestamp)
            metrics["loss"].append(loss)
            metrics["psnr"].append(float(out.psnr))
            metrics["timestamps"].append(cam.timestamp)
            metrics["backgrounds"].append(bg_np)
            if progress and it % LOG_EVERY == 0:
                progress(it, loss, float(out.psnr))
            # the NaN flag of this iteration's update, read now (no lag)
            ran = []
            if bool(out.nan_flag):
                self._dump_debug_snapshot()
                self._host_event("prune_nan", D.prune_nan)
                ran.append("prune_nan")

            if it in self.test_iterations:
                report = self.evaluate_test_set()
                metrics.setdefault("test_reports", []).append((it, report))

            ran += self._scheduled_events(it)
            _sync(dev)
            metrics["iter_ms"].append((time.perf_counter() - t_it) * 1e3)
            if ran:
                metrics["event_iterations"].append(it)

        metrics["wall_time"] = time.perf_counter() - t_start
        return metrics

    # ------------------------------------------------------------------
    def _scheduled_events(self, it: int) -> list[str]:
        """Run the events due after iteration `it` (the reference's
        train.py:203-274) and return their kinds, in order."""
        cfg, opt = self.cfg, self.opt
        ran = []

        def event(kind, fn):
            ran.append(kind)
            return self._host_event(kind, fn)

        # densify / extract (train.py:203-234)
        if it < opt.densify_until_iter:
            if it > opt.densify_from_iter and it % opt.densification_interval == 0:
                use_err = it > opt.error_base_prune_steps
                ssim_due = use_err and it % (opt.densification_interval
                                             * opt.ssim_prune_every) == 0
                l1_due = use_err and it % (opt.densification_interval * opt.l1_prune_every) == 0
                event("densify_and_prune", lambda hm: D.densify_and_prune(
                    hm, cfg, opt, self.scene.cameras_extent, self.rng,
                    s_max_ssim=opt.s_max_ssim if ssim_due else 0.0,
                    s_l1_thres=opt.s_l1_thres if l1_due else 100.0,
                    d_max_ssim=opt.d_max_ssim if ssim_due else 0.0,
                    d_l1_thres=opt.d_l1_thres if l1_due else 100.0,
                ))
            elif (it > opt.extract_from_iter and it % opt.extracton_interval == 0
                  and self.last_cam is not None):
                candidate = self.error_tracker.pop_worst()
                if candidate is not None:
                    self._extract(candidate, event)
        if (it % (opt.densification_interval * 4) == 0
                and it < opt.densify_until_iter - 3000):
            event("adjust_temp_opa",
                  lambda hm: D.adjust_temp_opa(hm, cfg, max_dur=self.sample_len))

        if self.prune_inv and it < opt.iterations and it > 3000:
            event("prune_invisible", D.prune_invisible)
            if opt.l1_accum:
                event("prune_small", D.prune_small)
            self.prune_inv = False

        # progressive growth (train.py:257-274)
        if (it > opt.extract_from_iter
                and it % opt.progressive_growing_steps == opt.make_dynamic_interval
                and self.need_extract):
            self.mark_last = True
            self.need_extract = False

        if (it > opt.extract_from_iter and it % opt.progressive_growing_steps == 0
                and it > opt.progressive_growing_steps):
            self.sample_len = min(
                self.scene.duration + cfg.time_shift,
                cfg.time_interval * cfg.progressive_step + self.scene.sample_len,
            )
            self.scene.set_sampling_len(self.sample_len, sample_every=cfg.sample_every)
            expanded = event("expand_duration", lambda hm: D.expand_duration(
                hm, cfg, min(self.scene.duration + cfg.time_shift, self.sample_len)))
            if expanded:
                self.e_count += 1
                if self.e_count >= opt.extract_every:
                    self.mark_last = True
                    self.need_extract = True
                    self.e_count = 0

        if self.mark_extract and self.last_cam is not None:
            self._extract(self.last_cam.timestamp, event)
            self.mark_extract = False
        return ran

    def _extract(self, timestamp: float, event) -> None:
        vis = self.last_vis.cpu().numpy() if self.last_vis is not None else None
        loc = np.asarray(self.last_cam.T, np.float32)
        event("extract_dynamic_from_static", lambda hm: D.extract_dynamic_from_static(
            hm, self.cfg, loc, timestamp,
            vis[: hm.n_static] if vis is not None else np.ones(hm.n_static, bool),
            self.scene.cameras_extent,
            percentile=self.opt.extract_percentile,
            max_dur=self.sample_len,
        ))

    def evaluate_test_set(self, max_frames: int = 8) -> dict:
        """In-training validation (training_report, train.py:306-368): render
        a slice of the test cameras at their timestamps, report mean PSNR."""
        cams = self.scene.sampled_test_cameras()[:max_frames]
        if not cams:
            return {"n_frames": 0}
        dev = self.device
        # same background as training (training_report uses the configured bg)
        bg = torch.tensor([1.0, 1.0, 1.0] if self.cfg.white_background else [0.0, 0.0, 0.0],
                          device=dev)
        vals = []
        with torch.no_grad():
            for cam, gt in self.prefetcher.epoch(cams, shuffle=False):
                img = render(cam.render_camera(dev), self.model, self.cfg, t=cam.timestamp,
                             bg=bg, capacity=self.capacity, kernel_cfg=self.kernel,
                             device=dev).render
                self.test_renders += 1
                vals.append(float(psnr_fn(torch.clamp(img, 0, 1), gt)))
        return {"n_frames": len(vals), "psnr": float(np.mean(vals))}

    def _dump_debug_snapshot(self) -> None:
        """Arg-dump-on-failure (the reference's debug snapshot,
        diff_gaussian_rasterization_df/__init__.py:92-99,152-159): when a
        step produced NaNs, the full pre-prune parameters and the camera
        that triggered it go to `nan_snapshot_<iteration>.npz` in
        `debug_snapshot_dir`, with the JAX trainer's keys."""
        if not self.debug_snapshot_dir:
            return
        os.makedirs(self.debug_snapshot_dir, exist_ok=True)
        payload = {f"param:{k}": v.detach().cpu().numpy() for k, v in self.model.params.items()}
        payload["iteration"] = np.asarray(self.iteration)
        if self.last_cam is not None:
            rc = self.last_cam.render_camera(self.device)
            payload["cam_view"] = rc.view.cpu().numpy()
            payload["cam_proj"] = rc.proj.cpu().numpy()
            payload["cam_timestamp"] = np.asarray(self.last_cam.timestamp)
        path = os.path.join(self.debug_snapshot_dir, f"nan_snapshot_{self.iteration}.npz")
        np.savez(path, **payload)
        print(f"[debug] NaN detected; state dumped to {path}", flush=True)

    def _gui_render(self, req) -> torch.Tensor:
        """The live model for a viewer request (network_gui analog: the
        viewer drives the timestamp and the scaling modifier)."""
        self.gui_renders += 1
        with torch.no_grad():
            return render(req.camera, self.model, self.cfg, t=req.timestamp,
                          bg=torch.zeros(3, device=self.device), capacity=self.capacity,
                          scaling_modifier=req.scaling_modifier, kernel_cfg=self.kernel,
                          # the wire carries RGB only: no dominant-index bookkeeping
                          track_idx=False, device=self.device).render

    # ------------------------------------------------------------------
    def save(self, model_path: str, iteration: int | None = None) -> D.HostModel:
        """The reference-layout `point_cloud/iteration_N/point_cloud.ply`
        (+ `dynamic_point_cloud.ply`) and `chkpntN.npz`; returns the
        HostModel that was written."""
        it = iteration or self.iteration
        hm = D.pull(self.model, self.opt_state)
        pc_dir = os.path.join(model_path, "point_cloud", f"iteration_{it}")
        os.makedirs(pc_dir, exist_ok=True)
        save_model_ply(hm, os.path.join(pc_dir, "point_cloud.ply"))
        save_checkpoint(
            os.path.join(model_path, f"chkpnt{it}.npz"), hm, it,
            extra={"sample_len": self.sample_len, "kernel_config": self.kernel.to_json()},
        )
        return hm
