"""Drive the PyTorch/CUDA port's render and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit and no result line):

1. build: compile every CUDA kernel from ex4dgs_tpu_torch/csrc/ with nvcc
   (sm_90a), one nvcc per source, all started together; print the build time
   and ptxas' register/shared-memory report.
2. scene: the bench scene of bench.py at full width (100k static + 10k
   dynamic splats, 1352x1014, scaling clamped to log(0.02)); the instance
   buffer is sized as bench.py sizes it (probe at 2M, then
   round_capacity(total * 5 // 4, 65536)).
3. forward kernel vs plain: one frame's packed instances go through the
   forward-compositing kernel and through its plain PyTorch version on the
   card; accum and tfinal must agree within 2e-5, the normalised depth
   within 1e-4 and the dominant ids on >= 99.9% of pixels. Both are timed
   with CUDA events, and the least time the card could take for the same
   work is computed from this frame's data.
4. render path: rendering.render at t = 0, 1, 2.5, 4, 7.5 with track_idx
   True and False, then the FPS recipe of eval/render_sets.py (per-call host
   timing ending in torch.cuda.synchronize, warm-up calls dropped). The
   launch counters are set to 0 just before and read just after; the
   forward kernel must have launched once per render, every output must be
   finite, no frame may overflow its capacity and no image may be all
   background.
5. backward kernel vs plain: the same frame, kernel A's accum and tfinal,
   and seeded O(1) cotangents go through the backward-compositing kernel
   and its plain version; element by element |kernel - plain| <= 1e-5 |plain|
   + 1e-6 max |plain| of its row group (xy, conic, opacity, features),
   columns outside every tile's range exactly zero, two launches bit-equal.
   Timed and bounded as in phase 3.
6. training path: train.step.train_step at full width (OptimizationConfig
   defaults, spatial_lr_scale 3.0, gt zeros, t = i % 5, iteration 100, the
   train step of bench.py), 31 steps carrying model and optimizer state.
   Every step must launch each kernel exactly once (counters reset before
   each step), give a finite loss and finite params, not overflow and leave
   nan_flag false; the loss after the last step (t = 0) must be below the
   first's (t = 0).
7. determinism: two train_steps from the same state give bit-equal params,
   moments and stats.
8. timing: train ms/iteration by bench.py's recipe (20 iterations from one
   state, best of 3 windows, each ending in torch.cuda.synchronize), and a
   torch.profiler breakdown of one step.
9. reference: a small scene rendered, and trained one step, on the card and
   on the CPU (plain path) must agree.

The lines before the last are the card's name and power limit (as
nvidia-smi prints them) and a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Card peaks used for the bound (NVIDIA H100 SXM data sheet, 132 SMs at the
# 1.98 GHz boost clock). The fp32 rate is counted in instruction slots: 128
# lanes per SM each issue one fp32 instruction per clock, an FMA or any
# other (the data sheet's 67 TFLOP/s counts an FMA as 2). The SFU rate is the
# CUDA programming guide's 16 exp2 results per clock per SM.
HBM_BYTES_S = 3.35e12
FP32_SLOTS_S = 132 * 128 * 1.98e9
SFU_OPS_S = 132 * 16 * 1.98e9
# fp32 instructions per instance x pixel pair in csrc/composite_fwd.cu. An
# evaluated pair: dx, dy (2), the unfused power (4 multiplies and an add for
# the quadratic, 3 multiplies and a subtraction for the rest: 9), the
# power <= 0 test, the opacity multiply, the clamp to 0.99 and the
# alpha >= 1/255 test (4): 15, plus one exp on the SFU (its fp32 range
# reduction is not counted). An applied pair adds 1 - alpha, the next
# transmittance, the latch test, the weight, 8 feature FMAs and the
# best-weight test: 13. Loop, index and shared-memory instructions are not
# counted, so the bound stays a lower bound.
SLOTS_EVAL, SLOTS_APPLIED = 15, 13
# csrc/composite_bwd.cu: an evaluated pair costs the forward's 15; an applied
# pair the transmittance update and weight (4), the colour prefix and dot
# (3 + 3), S_i (4), dL/dalpha (5, the division counted as 1), the opacity
# and power terms (2), the five geometry rows (14) and the eight feature
# rows (8): 43, plus one add per gradient row into its instance's sum (14),
# the least any reduction over the pixels needs. Its SFU work: the exp of
# every evaluated pair and the reciprocal of every applied one.
SLOTS_EVAL_B, SLOTS_APPLIED_B = 15, 57
BWD_ROWS = {"xy": slice(0, 2), "conic": slice(2, 5), "opacity": slice(5, 6),
            "features": slice(6, 14)}
# Kernel B sums each instance's pixels in another order than its plain
# version: an element may differ by BWD_RTOL of itself plus BWD_ATOL of its
# row group's largest magnitude.
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6
TRAIN_STEPS = 31  # t = i % 5: the first and the last step both render t = 0

TIMESTAMPS = (0.0, 1.0, 2.5, 4.0, 7.5)
W, H = 1352, 1014


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def profile_frames(frame, n: int = 3, top: int = 12):
    """Where a call's time goes: torch.profiler over n calls. Returns
    (wall ms per call under the profiler, device ms per call, device
    events per call, [(kernel, device ms per call, launches per call)] for
    the `top` kernels by device time), or None when the profiler saw no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # Only the device's own events (kernels, copies, fills): an operator's
    # row repeats the time of the kernels it launched.
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top]


def report_profile(what: str, fn, card: str) -> None:
    """Log profile_frames' breakdown of fn and the peak memory since the
    last reset."""
    breakdown = profile_frames(fn)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if breakdown is None:
        log(f"# profile {what}: device time not measured (the profiler saw no device "
            f"activity); peak memory {peak_gib:.2f} GiB")
        return
    wall_p, dev_p, n_events, rows = breakdown
    log(f"# profile {what} (torch.profiler, 3 calls): {wall_p:.3f} ms/call wall under the "
        f"profiler, {dev_p:.3f} ms/call device busy ({100 * dev_p / wall_p:.1f}%) in "
        f"{n_events:.0f} device kernels and copies per call, peak memory {peak_gib:.2f} GiB; "
        f"{card}")
    for name, ms_k, count in rows:
        log(f"#   {ms_k:8.4f} ms  x{count:5.1f}  {name[:100]}")


def walked_pairs(data, starts, stops, grid_x, tile_x, tile_y, chunk=64, tile_batch=1024):
    """(evaluated, applied) instance x pixel pairs of one frame: a pair is
    evaluated when its pixel has not latched before it (transmittance still
    >= T_EPS), applied when it also contributes. This is the work the blend
    needs, with per-pixel early exit; the kernel may walk more."""
    from ex4dgs_tpu_torch.ops import compositing as comp
    from ex4dgs_tpu_torch.ops.rasterize_tiled import tile_pixels

    dev = data.device
    rows = data[:6].t()
    xy, conic, opac = rows[:, 0:2], rows[:, 2:5], rows[:, 5]
    capacity = rows.shape[0]
    T = starts.shape[0]
    pixf = tile_pixels(grid_x, T // grid_x, tile_x, tile_y, dev)
    lanes = torch.arange(chunk, device=dev)[None, :]
    evaluated = applied = 0
    for b in range(0, T, tile_batch):
        s = slice(b, b + tile_batch)
        st, sp = starts[s].long(), stops[s].long()
        cum_in = torch.ones(pixf[s].shape[:2], device=dev)
        longest = int((sp - st).max().item())
        for j in range(-(-longest // chunk)):
            idx = st[:, None] + j * chunk + lanes
            ok = idx < sp[:, None]
            ic = idx.clamp(0, capacity - 1)
            alpha, m = comp.chunk_alpha(pixf[s], xy[ic][:, None], conic[ic][:, None],
                                        opac[ic][:, None], ok[:, None])
            cum = cum_in[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
            cum_excl = torch.cat([cum_in[..., None], cum[..., :-1]], dim=-1)
            evaluated += int((ok[:, None] & (cum_excl >= comp.T_EPS)).sum().item())
            applied += int((m & (cum >= comp.T_EPS)).sum().item())
            cum_in = cum[..., -1]
    return evaluated, applied


def bound_of(nbytes: float, slots: float, sfu_ops: float):
    """(bound ms, bound_by, its three parts in ms): the least time for the
    work, the larger of bytes over the memory rate and operations over the
    fp32 and SFU rates."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_fp32 = slots / FP32_SLOTS_S * 1e3
    t_sfu = sfu_ops / SFU_OPS_S * 1e3
    by = "bytes" if t_bytes >= max(t_fp32, t_sfu) else "operations"
    return max(t_bytes, t_fp32, t_sfu), by, (t_bytes, t_fp32, t_sfu)


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    import ex4dgs_tpu_torch  # noqa: F401  (sets the precision policy)
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.models.state import round_capacity
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.binning import bin_gaussians
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.ops.rasterize_cuda import (composite_tiles_bwd_plain,
                                                     composite_tiles_plain, pack_sorted)
    from ex4dgs_tpu_torch.rendering import preprocess_points, render
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
    from ex4dgs_tpu_torch.train.step import StepStatics, train_step

    dev = torch.device("cuda")
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_all()
    log(f"# build: {len(kernels.launches)} kernel(s) in {time.perf_counter() - t0:.2f} s "
        "(one nvcc per source, in parallel)")
    for name, text in kernels.build_logs.items():
        for line in text.strip().splitlines():
            log(f"#   {name}: {line.strip()}")

    # -- 2. scene --------------------------------------------------------
    t0 = time.perf_counter()
    model, cfg = make_scene(n_static=100_000, n_dynamic=10_000, duration=10.0,
                            static_capacity=100_000, dynamic_capacity=16_384, device=dev)
    model.params["scaling"] = torch.clamp_max(model.params["scaling"], math.log(0.02))
    cam = ring_cameras(1, 3.0, W, H, far=cfg.far, device=dev)[0]
    bg = torch.zeros(3, device=dev)
    probe = render(cam, model, cfg, t=1.0, bg=bg, capacity=2 * 1024 * 1024, device=dev)
    total = int(probe.binning_total.item())
    if total > 2 * 1024 * 1024:
        fail(f"bench scene overflows the 2M probe capacity ({total})")
    capacity = min(2 * 1024 * 1024, round_capacity(total * 5 // 4, 65536))
    torch.cuda.synchronize()
    log(f"# scene: {model.static_capacity} + {model.dynamic_capacity} splats, {W}x{H}, "
        f"{total} instances at t=1 (capacity {capacity}), built in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 3. forward kernel vs plain ------------------------------------
    tx, ty = 32, 16
    gx, gy = tile_grid(W, H, tx, ty)
    pts = point_data_at_t(model, cfg, 1.0)
    proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far)
    flow = torch.zeros((proj.xy.shape[0], 3), device=dev)
    binning = bin_gaussians(proj, gx, gy, capacity)
    data, gid = pack_sorted(proj, colors, flow, binning)
    starts, stops = binning.tile_start, binning.tile_stop
    args = (data, gid, starts, stops)
    kw = dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True)
    acc_k, tf_k, idx_k = kernels.composite_fwd(*args, **kw)
    acc_p, tf_p, idx_p = composite_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    err_acc = (acc_k - acc_p).abs().max().item()
    err_tf = (tf_k - tf_p).abs().max().item()

    def depth_of(a):
        has = a[..., 7] > 0
        return torch.where(has, a[..., 3] / torch.where(has, a[..., 7], 1.0), cfg.far)

    err_depth = (depth_of(acc_k) - depth_of(acc_p)).abs().max().item()
    agree = (idx_k == idx_p).float().mean().item()
    finite = all(bool(torch.isfinite(x).all()) for x in (acc_k, tf_k))
    log(f"# composite_fwd vs plain: accum {err_acc:.3g} (atol 2e-5), tfinal {err_tf:.3g} "
        f"(atol 2e-5), depth {err_depth:.3g} (atol 1e-4), bestidx agreement {agree:.6f} "
        f"(>= 0.999), finite {finite}")
    if not (finite and err_acc <= 2e-5 and err_tf <= 2e-5 and err_depth <= 1e-4
            and agree >= 0.999):
        fail("composite_fwd disagrees with its plain version")
    if not bool((idx_k >= -1).all()) or int(idx_k.max().item()) >= proj.xy.shape[0]:
        fail("composite_fwd wrote an id outside [-1, P)")
    del acc_p, tf_p, idx_p

    ms = cuda_ms(lambda: kernels.composite_fwd(*args, **kw), reps=20)
    ms_noidx = cuda_ms(lambda: kernels.composite_fwd(*args, **{**kw, "track_idx": False}),
                       reps=20)
    plain_ms = cuda_ms(lambda: composite_tiles_plain(*args, **kw), reps=2, warmup=1)
    evaluated, applied = walked_pairs(data, starts, stops, gx, tx, ty)
    n_inst = int(stops[-1].item() - starts[0].item())
    T, npix = starts.shape[0], tx * ty
    nbytes = 14 * 4 * n_inst + 4 * n_inst + 2 * 4 * T + T * npix * (8 + 1 + 1) * 4
    bound_ms, bound_by, (t_bytes, t_fp32, t_sfu) = bound_of(
        nbytes, SLOTS_EVAL * evaluated + SLOTS_APPLIED * applied, evaluated)
    log(f"# composite_fwd: {ms:.4f} ms/frame (track_idx=False {ms_noidx:.4f}), plain "
        f"{plain_ms:.2f} ms; {n_inst} instances in {T} tiles; pairs evaluated {evaluated}, "
        f"applied {applied}; bound {bound_ms:.4f} ms (bytes {t_bytes:.4f}, fp32 "
        f"{t_fp32:.4f}, sfu exp {t_sfu:.4f}); {card}")

    # -- 4. render path ----------------------------------------------------
    def frame(t, track_idx):
        return render(cam, model, cfg, t=t, bg=bg, capacity=capacity, track_idx=track_idx,
                      device=dev)

    for track_idx in (True, False):  # warm-up: allocator, caches
        frame(1.0, track_idx)
    torch.cuda.synchronize()

    kernels.reset_launches()
    n_frames = 0
    for t in TIMESTAMPS:
        for track_idx in (True, False):
            t0 = time.perf_counter()
            res = frame(t, track_idx)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            n_frames += 1
            tot = int(res.binning_total.item())
            outs = (res.render, res.depth, res.opticalflow, res.acc)
            if tot > capacity:
                fail(f"t={t}: {tot} instances overflow the capacity {capacity}")
            if not all(bool(torch.isfinite(o).all()) for o in outs):
                fail(f"t={t} track_idx={track_idx}: non-finite output")
            if tuple(res.render.shape) != (H, W, 3) or float(res.acc.max()) <= 0.0:
                fail(f"t={t} track_idx={track_idx}: wrong shape or all background")
            idx = res.dominent_idxs
            if not track_idx and bool((idx != -1).any()):
                fail("track_idx=False must give idx all -1")
            if track_idx and not bool((idx >= 0).any()):
                fail(f"t={t}: no dominant contributor anywhere")
            log(f"# render t={t} track_idx={track_idx}: {tot} instances, {dt:.3f} ms, "
                f"acc mean {res.acc.mean().item():.4f}")

    fps = {}
    for track_idx in (True, False):
        times = []
        for _ in range(2):  # rounds
            for i in range(30):
                t0 = time.perf_counter()
                frame(1.0, track_idx)
                torch.cuda.synchronize()
                if i >= 10:  # warm-up calls dropped
                    times.append(time.perf_counter() - t0)
                n_frames += 1
        fps[track_idx] = statistics.mean(times) * 1e3
    render_launches = dict(kernels.launches)
    log(f"# render path: {n_frames} renders, launches {render_launches}")
    if render_launches["composite_fwd"] != n_frames:
        fail(f"composite_fwd launched {render_launches['composite_fwd']} times in "
             f"{n_frames} renders")
    for track_idx, ms_f in fps.items():
        log(f"# FPS recipe t=1 track_idx={track_idx}: {ms_f:.3f} ms/frame, "
            f"{W * H / ms_f / 1e3:.2f} Mpix/s, {1e3 / ms_f:.1f} FPS; {card}")
    torch.cuda.reset_peak_memory_stats()
    report_profile("render t=1 track_idx=True", lambda: frame(1.0, True), card)

    # -- 5. backward kernel vs plain -------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    gacc = torch.randn(acc_k.shape, device=dev, generator=gen)
    gend = torch.randn(tf_k.shape, device=dev, generator=gen)
    acdot = (acc_k[..., 0:3] * gacc[..., 0:3]).sum(-1, keepdim=True)
    bargs = (data.detach(), starts, stops, gacc, acdot, gend, tf_k)
    bkw = dict(grid_x=gx, tile_x=tx, tile_y=ty)
    d_k = kernels.composite_bwd(*bargs, **bkw)
    d_k2 = kernels.composite_bwd(*bargs, **bkw)
    d_p = composite_tiles_bwd_plain(*bargs, **bkw)
    torch.cuda.synchronize()
    lo, hi = int(starts[0].item()), int(stops[-1].item())
    errs, worst, median, floor = {}, {}, {}, {}
    for name, rows in BWD_ROWS.items():
        ref = d_p[rows, lo:hi]
        diff = (d_k[rows, lo:hi] - ref).abs()
        mag = ref.abs()
        floor[name] = BWD_ATOL * mag.max().item()
        limit = BWD_RTOL * mag + floor[name]
        errs[name] = diff.max().item()
        worst[name] = (diff / limit.clamp_min(1e-30)).max().item()  # <= 1 passes
        median[name] = mag[mag > 0].median().item() if bool((mag > 0).any()) else 0.0
    outside_zero = not (d_k[:, :lo].any() or d_k[:, hi:].any() or d_k[14:].any())
    bit_equal = torch.equal(d_k, d_k2)
    finite_b = bool(torch.isfinite(d_k).all())
    log(f"# composite_bwd vs plain, per element |kernel - plain| <= {BWD_RTOL:g} |plain| + "
        f"{BWD_ATOL:g} max |plain| per row group: "
        + ", ".join(f"{k} max err {errs[k]:.3g}, worst err/limit {worst[k]:.3g}, floor "
                    f"{floor[k]:.3g}, median non-zero |plain| {median[k]:.3g}" for k in errs)
        + f"; outside the ranges zero {outside_zero}; two launches bit-equal {bit_equal}; "
        f"finite {finite_b}")
    if not (finite_b and outside_zero and bit_equal and max(worst.values()) <= 1.0):
        fail("composite_bwd disagrees with its plain version")
    err_bwd = max(errs.values())
    del d_k2, d_p
    ms_b = cuda_ms(lambda: kernels.composite_bwd(*bargs, **bkw), reps=20)
    plain_ms_b = cuda_ms(lambda: composite_tiles_bwd_plain(*bargs, **bkw), reps=2, warmup=1)
    nbytes_b = (14 + 16) * 4 * n_inst + 2 * 4 * T + T * npix * (8 + 3) * 4
    bound_b, bound_by_b, (tb_bytes, tb_fp32, tb_sfu) = bound_of(
        nbytes_b, SLOTS_EVAL_B * evaluated + SLOTS_APPLIED_B * applied, evaluated + applied)
    log(f"# composite_bwd: {ms_b:.4f} ms/frame, plain {plain_ms_b:.2f} ms; pairs evaluated "
        f"{evaluated}, applied {applied}; bound {bound_b:.4f} ms (bytes {tb_bytes:.4f}, "
        f"fp32 {tb_fp32:.4f}, sfu {tb_sfu:.4f}); {card}")
    del bargs, gacc, gend, acdot, d_k, acc_k, tf_k, idx_k, data, gid

    # -- 6. training path ------------------------------------------------
    statics = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=3.0,
                          capacity=capacity)
    gt = torch.zeros((H, W, 3), device=dev)
    state = init_state(model.params, device=dev)

    def step(m, st, t):
        return train_step(m, st, cam, gt, t, bg, 100, statics, device=dev)

    step(model, state, 1.0)  # warm-up: allocator, caches
    torch.cuda.synchronize()
    train_launches = {name: 0 for name in kernels.launches}
    losses = []
    m, st = model, state
    for i in range(TRAIN_STEPS):
        kernels.reset_launches()
        out = step(m, st, float(i % 5))
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        for name, n in counts.items():
            train_launches[name] += n
        loss = out.loss.item()
        if counts != {"composite_fwd": 1, "composite_bwd": 1}:
            fail(f"train step {i}: kernel launches {counts}, expected one of each")
        if int(out.binning_total.item()) > capacity:
            fail(f"train step {i}: {int(out.binning_total)} instances overflow {capacity}")
        if not math.isfinite(loss) or bool(out.nan_flag):
            fail(f"train step {i}: loss {loss}, nan_flag {bool(out.nan_flag)}")
        if not all(bool(torch.isfinite(v).all()) for v in out.model.params.values()):
            fail(f"train step {i}: non-finite params")
        m, st = out.model, out.opt_state
        losses.append(loss)
    log(f"# training path: {TRAIN_STEPS} steps, launches {train_launches}; loss "
        f"{losses[0]:.6f} (step 0, t=0) -> {losses[-1]:.6f} (step {TRAIN_STEPS - 1}, t=0); "
        f"psnr {out.psnr.item():.3f} dB; optimizer step {int(st.step)}")
    if not losses[-1] < losses[0]:
        fail("the training loss did not fall")

    # -- 7. determinism ------------------------------------------------------
    a = step(m, st, 1.0)
    b = step(m, st, 1.0)
    same = all(torch.equal(a.model.params[k], b.model.params[k])
               and torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
               and torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]) for k in m.params)
    same = same and all(torch.equal(a.model.stats[k], b.model.stats[k]) for k in m.stats)
    log(f"# determinism: two train steps from one state bit-equal {same}")
    if not same:
        fail("two train steps from the same state differ")
    del a, b

    # -- 8. timing -----------------------------------------------------------
    def tick(i):
        return step(model, state, float(i % 5))

    for i in range(2):
        tick(i)
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(20):
            tick(i)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
    train_ms = min(windows) / 20 * 1e3
    log(f"# train step (bench.py recipe: 20 iterations, best of 3 windows): "
        f"{train_ms:.3f} ms/iteration, {W * H / train_ms / 1e3:.2f} Mpix/s; windows "
        + ", ".join(f"{w * 1e3 / 20:.3f}" for w in windows) + f" ms/iteration; {card}")
    torch.cuda.reset_peak_memory_stats()
    report_profile("train step t=1", lambda: tick(1), card)

    # -- 9. reference on a small input ------------------------------------
    small, small_train = {}, {}
    gt_small = torch.as_tensor(np.random.default_rng(0).uniform(size=(96, 160, 3))
                               .astype(np.float32))
    for d in ("cuda", "cpu"):
        m_s, c_s = make_scene(n_static=3000, n_dynamic=300, duration=10.0, seed=1, device=d)
        cam_s = ring_cameras(1, 3.0, 160, 96, far=c_s.far, device=d)[0]
        bg_s = torch.tensor([0.1, 0.2, 0.3]).to(d)
        small[d] = render(cam_s, m_s, c_s, t=2.5, bg=bg_s, capacity=65536, device=d)
        st_s = StepStatics(cfg=c_s, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                           capacity=65536)
        small_train[d] = train_step(m_s, init_state(m_s.params, device=d), cam_s,
                                    gt_small.to(d), 2.5, bg_s, 100, st_s, device=d)
    g, c = small["cuda"], small["cpu"]
    err_small = (g.render.cpu() - c.render).abs().max().item()
    err_small_acc = (g.acc.cpu() - c.acc).abs().max().item()
    agree_small = (g.dominent_idxs.cpu() == c.dominent_idxs).float().mean().item()
    log(f"# small scene 160x96, cuda vs cpu: color {err_small:.3g}, acc {err_small_acc:.3g} "
        f"(atol 1e-4), idx agreement {agree_small:.5f} (>= 0.99), instances "
        f"{int(g.binning_total)} vs {int(c.binning_total)}")
    if not (err_small <= 1e-4 and err_small_acc <= 1e-4 and agree_small >= 0.99):
        fail("the card's render of the small scene disagrees with the CPU's")
    g, c = small_train["cuda"], small_train["cpu"]
    loss_rel = abs(g.loss.item() - c.loss.item()) / abs(c.loss.item())
    param_err = max((g.model.params[k].cpu() - c.model.params[k]).abs().max().item()
                    for k in c.model.params if c.model.params[k].numel())
    mu_rel = max((g.opt_state.mu[k].cpu() - c.opt_state.mu[k]).abs().max().item()
                 / max(c.opt_state.mu[k].abs().max().item(), 1e-30)
                 for k in c.model.params if c.opt_state.mu[k].abs().max().item() > 0)
    log(f"# small scene train step, cuda vs cpu: loss rel {loss_rel:.3g} (<= 1e-5), params "
        f"{param_err:.3g} (atol 1e-6), first moments {mu_rel:.3g} of their largest (<= 1e-3)")
    if not (loss_rel <= 1e-5 and param_err <= 1e-6 and mu_rel <= 1e-3):
        fail("the card's train step on the small scene disagrees with the CPU's")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "ex4dgs_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "ex4dgs_tpu/ops/rasterize_pallas.py:439",
        "launches": render_launches["composite_fwd"] + train_launches["composite_fwd"],
        "max_abs_err": max(err_acc, err_tf),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "ex4dgs_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "ex4dgs_tpu/ops/rasterize_pallas.py:713",
        "launches": train_launches["composite_bwd"],
        "max_abs_err": err_bwd,
        "ms": ms_b,
        "plain_ms": plain_ms_b,
        "bound_ms": bound_b,
        "bound_by": bound_by_b,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
