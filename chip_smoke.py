"""Drive the PyTorch/CUDA port's render, training, eval and viewer paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit and no result line):

1. build: compile every CUDA kernel from ex4dgs_tpu_torch/csrc/ with nvcc
   (sm_90a), one nvcc per source, all started together; print the build time
   and ptxas' register/shared-memory report.
2. scene: ex4dgs_tpu_torch.bench_frame.bench_scene, the bench scene of
   bench.py at full width (100k static + 10k dynamic splats, 1352x1014,
   scaling clamped to log(0.02)); the instance buffer is sized as bench.py
   sizes it (probe at 2M, then round_capacity(total * 5 // 4, 65536)).
3. forward kernel vs plain: one frame's packed instances (bench_frame.
   pack_frame at t = 1, 32x16 tiles) go through the forward-compositing
   kernel and through its plain PyTorch version on the card; accum and
   tfinal must agree within 2e-5, tfinal also within TF_RTOL of itself off
   the latch (ops/rasterize_cuda.py::tfinal_rel_err; a dropped contributing
   pair moves it by 3.9e-3), the
   normalised depth within 1e-4 and the dominant ids on >= 99.9% of pixels;
   two launches must be bit-equal. Both are timed with CUDA events. The
   frame's pairs are counted (evaluated, contributing, applied, and walked
   by warps with and without the twin of the kernel's per-warp cull, which
   must drop no contributing pair), and the least time the card could take
   for the work these inputs need is computed from the contributing and
   applied pairs (the old bound, from every evaluated pair, beside it).
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
   columns outside every tile's range exactly zero, two launches bit-equal,
   and bit-equal to its twin (ops/rasterize_cuda.py::composite_tiles_bwd_walk:
   the kernel's arithmetic and order of sums in PyTorch).
   Timed and bounded as in phase 3, beside the counts of its walk from the
   cull's twin: warp steps with and without the per-warp cull, the steps
   with an applied lane (the ones it reduces) spread by 1, 2-8 and 9-32
   applied lanes, and the shuffles those steps take with a butterfly per
   value and with the kernel's transposed reduction.
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
10. probes: the layout probes P1 (`probes.unaligned`: [16, 256] windows of
   f32[16, 2^20] from aligned and arbitrary starts) and P2
   (`probes.outspec`: narrow against wide per-tile blocks, T = 2752) run
   through their `main`s with the counters set to 0 just before, and every
   probe kernel must have launched. Each kernel is then held against its
   plain version on the card: exactly for the copies and fills, within 1e-6
   of each tile's sum of |x| for the sums on seeded normal inputs (exactly
   on the probe's all-ones inputs); two launches bit-equal. Each launch is
   timed by its own CUDA events after a 512 MiB scratch write (the median
   of 20 or 30 is reported), and no launch may beat its bytes bound by more
   than 5% (a reading that does was served by L2, not by memory). P1 also
   runs at kernel A's own starts: the bench frame's nonempty tile starts.
   P2a and P2b are then timed in turns against the fill_ calls that write
   the same outputs (kernel, fills, fills, kernel), and each ratio is set
   beside the spread of its turns.
11. subpixel path: the frame of phase 3 with the bench frame's seeded
   subpixel offsets (bench_frame.bench_offsets, U(-0.5, 0.5) per pixel and
   coordinate) goes through kernel A with offsets, held to its plain
   version as in phase 3 (and it must differ from the frame without
   offsets), and kernel B with offsets, bit-equal to its twin and within
   BWD_RTOL/BWD_ATOL of its plain version as in phase 5; two launches of
   each bit-equal. A and B are timed with and without offsets in turns
   (without, with, with, without), the frame's lane-pairs are counted with
   the offset pixels and the offset-aware cull's twin (which must drop no
   contributing pair), and the bounds come from the offset frame's
   contributing pairs. Then the subpixel main path, with the counters set
   to 0 just before and read just after: rendering.render(...,
   subpixel_offset=off) at t = 0, 1 and 2.5 (one launch of kernel A each)
   and one loss.backward() through a render at t = 1 (one launch of A and
   one of B, finite gradients). Last, phase 9's small scene rendered and
   differentiated with offsets on the card and on the CPU must agree.
12. trainer path: a seeded on-disk N3V scene (bench_frame.write_n3v_scene:
   4 cameras x 8 frames of 2704x2028 PNG, 100k points) is trained by the
   training CLI, `python -m ex4dgs_tpu_torch.train --config
   configs/N3V/n3v_base.json` (1352x1014 frames, every point) run as a
   user runs it, in a process of its own, with only the schedule shortened
   (TRAIN_SCHEDULE) so that 150 iterations cross every event kind that the
   schedule reaches before iteration 3000 (densify_and_prune,
   adjust_temp_opa, expand_duration, static->dynamic extraction), with a
   save and the test-set PSNR at 150; then it resumes from chkpnt150.npz
   for 10 more iterations. The CLI sets the launch counters to 0 before
   training and reports them with everything else in its
   train_report.json. Every loss must be finite and the last 10 must
   average below the first 10; every scheduled event kind must have run;
   kernel A must have launched once per train_step (iterations plus
   overflow retries) and per test render, kernel B once per iteration,
   nothing else; the PLY and the checkpoint must exist and
   push(load_checkpoint(...)) on the card must pull back bit-equal to the
   trainer's pull at save (sha256 of every array). Printed: ms/iteration by
   the host clock (whole loop, and without the event iterations), each
   event's time, pull and push times, n_static/n_dynamic after each event,
   the GT cache's hits and bytes; the events the schedule does not reach
   before iteration 3000 (prune_invisible, prune_small) or at all
   (prune_nan, reset_opacity) are timed on the saved model. Last, the
   trainer on a tiny scene on the card and on the CPU for the 20
   iterations before its first event (losses within rtol 1e-5, the same
   cameras and backgrounds), and a forced overflow on the card (capacity
   256: one more launch of kernel A per retry, the same first loss).
13. eval and viewer path: the render CLI, `python -m
   ex4dgs_tpu_torch.render_cli --model_path <phase 12's model> --iteration
   150 --fps_inner 100`, in a process of its own, on both splits at
   1352x1014, with EX4DGS_LPIPS_WEIGHTS naming seeded random AlexNet/VGG
   weights written here (their values are labelled "seeded random weights,
   not LPIPS"): each split's frame count is the scene's sampled camera
   count, every metric is finite, mean_metrics.json carries the
   reference's keys, kernel A launched what the recipe implies (each
   metric frame and overflow retry; on the test split also the probe
   render, 20 x 100 FPS calls and one round of 100 at the training-sized
   capacity), and the test PSNR equals the trainer's at 150 within 1e-3 dB
   where the frame sets are the same. Printed: the FPS recipe's ms/frame,
   FPS and Mpix/s beside phase 4's, the host ms per frame of each metric.
   Then LPIPS (alex, vgg) of one rendered frame on the card against the CPU
   within rtol 1e-4, atol 1e-6, with TF32 off; viewer requests for one test
   camera at 1352x1014 (3 timestamps and a keep-alive) over loopback, each
   reply bit-equal to the converted render(..., track_idx=False) of its
   camera, one launch of kernel A per non-empty request; the tiny scene's
   Trainer serving one request during 3 iterations; and the quality
   probe's surface scene (50k + 5k splats, seed 7) from its 19-camera rig
   at 800x600, t = 0 and 4: finite, visible, moving, one launch per render,
   one camera equal to the CPU's plain render within 3e-5.

The lines before the last are the card's name and power limit (as
nvidia-smi prints them) and a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# Only contributing pairs (power <= 0 and alpha >= 1/255 before the pixel's
# latch) are charged the 15 slots and the exp: a kernel that culls per warp
# against the splat's extent never evaluates the others, so charging every
# evaluated pair (the bound printed as "old") no longer bounds it.
SLOTS_EVAL, SLOTS_APPLIED = 15, 13
# csrc/composite_bwd.cu: an evaluated pair costs the forward's 15; an applied
# pair the transmittance update and weight (4), the colour prefix and dot
# (3 + 3), S_i (4), dL/dalpha (5, the division counted as 1), the opacity
# and power terms (2), the five geometry rows (14) and the eight feature
# rows (8): 43, plus one add per gradient row into its instance's sum (14),
# the least any reduction over the pixels needs. Its SFU work: the exp of
# every contributing pair and the reciprocal of every applied one (as for
# kernel A, the pairs that do not contribute are not charged).
SLOTS_EVAL_B, SLOTS_APPLIED_B = 15, 57
# Shuffles per lane of a warp step that reduces kernel B's 14 values: a
# butterfly per value and the kernel's transposed reduction.
SHUFFLES_BUTTERFLY, SHUFFLES_TRANSPOSED = 5 * 14, 8 + 4 + 2 + 1 + 1
TRAIN_STEPS = 31  # t = i % 5: the first and the last step both render t = 0
# The probe kernels and the TPU kernels they replace.
PROBE_REPLACES = {
    "probe_unaligned": "tools/tpu_probes/_tpu_unaligned.py:19",
    "outspec_a": "tools/tpu_probes/_tpu_outspec.py:36",
    "outspec_b": "tools/tpu_probes/_tpu_outspec.py:59",
    "outspec_c": "tools/tpu_probes/_tpu_outspec.py:59",
    "outspec_d": "tools/tpu_probes/_tpu_outspec.py:81",
    "outspec_e": "tools/tpu_probes/_tpu_outspec.py:101",
}
SUM_RTOL = 1e-6  # P2 d and e: of each tile's sum of |x|
BOUND_SLACK = 1.05  # no probe launch may read above 105% of the memory rate

TIMESTAMPS = (0.0, 1.0, 2.5, 4.0, 7.5)


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


def walked_pairs(data, starts, stops, grid_x, tile_x, tile_y, chunk=64, tile_batch=256,
                 kernel_batch=256, offsets=None):
    """Instance x pixel pair counts of one frame (its pixels moved by the
    per-tile subpixel `offsets` when given), with per-pixel early exit:
    a pair is evaluated when its pixel has not latched before it
    (transmittance still >= T_EPS), contributing when it also passes the
    power and alpha tests, applied when the pixel does not latch on it.
    Warp-level counts are lane-pairs (32 per warp step): a warp steps on an
    instance while any of its 32 pixels is live, and with the per-warp cull
    only on the instances that warp_cull_plain (the twin of the kernel's
    cull) keeps. `slowest_warp` charges each kernel batch (256 instances
    from the tile's start, between two barriers) the culled walk of the
    block's slowest warp for every warp: the lane-pairs the block holds while
    its warps wait at the batch's barrier. `dropped` counts contributing
    pairs that the twin skips: it must be 0. `steps_applied` counts the
    warp steps with an applied pair (the steps kernel B reduces), and
    `steps_applied_1`, `_2_8`, `_9_32` spread them by applied lanes."""
    from ex4dgs_tpu_torch.ops import compositing as comp
    from ex4dgs_tpu_torch.ops.rasterize_cuda import warp_boxes, warp_cull_plain
    from ex4dgs_tpu_torch.ops.rasterize_tiled import tile_pixels

    dev = data.device
    rows = data[:6].t()
    xy, conic, opac = rows[:, 0:2], rows[:, 2:5], rows[:, 5]
    capacity = rows.shape[0]
    T = starts.shape[0]
    nw = tile_x * tile_y // 32
    pixf = tile_pixels(grid_x, T // grid_x, tile_x, tile_y, dev)
    if offsets is not None:
        pixf = pixf + offsets
    boxes = warp_boxes(grid_x, T, tile_x, tile_y, dev, offsets=offsets)
    lanes = torch.arange(chunk, device=dev)[None, :]
    n = dict.fromkeys(("evaluated", "contributing", "applied", "warp_walked",
                       "warp_walked_culled", "slowest_warp", "dropped", "steps_applied",
                       "steps_applied_1", "steps_applied_2_8", "steps_applied_9_32"), 0)
    for b in range(0, T, tile_batch):
        s = slice(b, b + tile_batch)
        st, sp = starts[s].long(), stops[s].long()
        cum_in = torch.ones(pixf[s].shape[:2], device=dev)
        longest = int((sp - st).max().item())
        per_warp = torch.zeros((st.shape[0], nw), dtype=torch.long, device=dev)
        for j in range(-(-longest // chunk)):
            idx = st[:, None] + j * chunk + lanes
            ok = idx < sp[:, None]
            ic = idx.clamp(0, capacity - 1)
            alpha, m = comp.chunk_alpha(pixf[s], xy[ic][:, None], conic[ic][:, None],
                                        opac[ic][:, None], ok[:, None])
            cum = cum_in[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
            cum_excl = torch.cat([cum_in[..., None], cum[..., :-1]], dim=-1)
            live = ok[:, None] & (cum_excl >= comp.T_EPS)  # [B, P, C]
            contributing = m & (cum_excl >= comp.T_EPS)
            n["evaluated"] += int(live.sum().item())
            n["contributing"] += int(contributing.sum().item())
            applied = m & (cum >= comp.T_EPS)
            n["applied"] += int(applied.sum().item())
            B = live.shape[0]
            lanes_applied = applied.reshape(B, nw, 32, -1).sum(2)  # [B, W, C]
            for key, lo_, hi_ in (("steps_applied", 1, 32), ("steps_applied_1", 1, 1),
                                  ("steps_applied_2_8", 2, 8), ("steps_applied_9_32", 9, 32)):
                n[key] += int(((lanes_applied >= lo_) & (lanes_applied <= hi_)).sum().item())
            warp_live = live.reshape(B, nw, 32, -1).any(2)  # [B, W, C]
            skip = warp_cull_plain(xy[ic][:, None], conic[ic][:, None], opac[ic][:, None],
                                   boxes[s][:, :, None, :])
            n["warp_walked"] += 32 * int(warp_live.sum().item())
            walked = warp_live & ~skip
            n["warp_walked_culled"] += 32 * int(walked.sum().item())
            per_warp += walked.sum(-1)
            if (j + 1) % (kernel_batch // chunk) == 0 or j + 1 == -(-longest // chunk):
                n["slowest_warp"] += 32 * nw * int(per_warp.amax(1).sum().item())
                per_warp.zero_()
            n["dropped"] += int((contributing.reshape(B, nw, 32, -1).any(2) & skip).sum().item())
            cum_in = cum[..., -1]
    return n


def bound_of(nbytes: float, slots: float, sfu_ops: float):
    """(bound ms, bound_by, its three parts in ms): the least time for the
    work, the larger of bytes over the memory rate and operations over the
    fp32 and SFU rates."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_fp32 = slots / FP32_SLOTS_S * 1e3
    t_sfu = sfu_ops / SFU_OPS_S * 1e3
    by = "bytes" if t_bytes >= max(t_fp32, t_sfu) else "operations"
    return max(t_bytes, t_fp32, t_sfu), by, (t_bytes, t_fp32, t_sfu)


def probe_line(name: str, readings, nbytes: float, slots: float, t: int, card: str,
               extra: str) -> tuple[float, float]:
    """Log one probe kernel's readings against its bound and fail if any
    launch beat the bound by more than BOUND_SLACK. Returns (median ms,
    bound ms)."""
    bound_ms, _, (t_bytes, _, _) = bound_of(nbytes, slots, 0)
    med, fastest = statistics.median(readings), min(readings)
    log(f"# {name}: {med:.4f} ms median of {len(readings)} launches ({med / t * 1e3:.4f} "
        f"us per tile or window; fastest {fastest:.4f}, slowest {max(readings):.4f}); bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at {HBM_BYTES_S / 1e12:.2f} TB/s), "
        f"{100 * bound_ms / med:.1f}% of it at the median, "
        f"{nbytes / med / 1e6:.1f} GB/s; {extra}; {card}")
    if fastest < t_bytes / BOUND_SLACK:
        fail(f"{name}: a launch took {fastest:.4f} ms, faster than its bytes bound "
             f"{t_bytes:.4f} ms allows: the timing did not reach memory")
    return med, bound_ms


def probe_phase(dev, starts, stops, card: str) -> list[dict]:
    """Phase 10: the probes' main path, then each probe kernel against its
    plain version and its bound. Returns the kernels-line entries."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import cuda_ms
    from ex4dgs_tpu_torch.probes import outspec, readings_ms, unaligned

    # The card idled through phase 9's CPU half: 200 fills of 1 GiB (200 GiB
    # written, ~64 ms at the memory rate) bring its clocks back up before
    # anything is timed.
    warm = torch.empty(2**28, device=dev)
    warm_ms = 200 * cuda_ms(lambda: warm.fill_(1.0), reps=200, warmup=0)
    log(f"# probes' clock warm-up: 200 GiB written in {warm_ms:.1f} ms; {card}")
    del warm
    kernels.reset_launches()
    p1 = unaligned.main(device=dev)
    p2 = outspec.main(device=dev)
    torch.cuda.synchronize()
    launched = dict(kernels.launches)
    log(f"# probes' main path: launches {launched}")
    missing = [k for k in PROBE_REPLACES if launched[k] == 0]
    if missing:
        fail(f"the probes' main path launched no {missing}")

    def entry(name, err, med, plain, bound, library):
        source = next(s for s, fns in kernels.SOURCES.items() if name in fns)
        return {"name": name, "route": "cuda", "source": f"ex4dgs_tpu_torch/csrc/{source}.cu",
                "replaces": PROBE_REPLACES[name], "launches": launched[name],
                "max_abs_err": err, "ms": med, "plain_ms": plain, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": library}

    # P1: the probe's two offset sets, and kernel A's own starts.
    src = unaligned.make_src(device=dev)
    n, g = src.shape[1], unaligned.G
    offs = {label: torch.from_numpy(o).to(dev) for label, o in unaligned.offset_sets().items()}
    offs["kernel A starts"] = starts[stops > starts].clamp(0, n - g).contiguous()
    readings = dict(p1)
    p1_result = {}
    for label, o in offs.items():
        got = kernels.probe_unaligned(src, o)
        again = kernels.probe_unaligned(src, o)
        want = unaligned.copy_windows_plain(src, o)
        torch.cuda.synchronize()
        exact, same = torch.equal(got, want), torch.equal(got, again)
        if label not in readings:  # checked above: time without the range check
            readings[label] = readings_ms(
                lambda: kernels.probe_unaligned(src, o, check_range=False), dev, 20)
        aligned16 = (o % 4 == 0).float().mean().item()
        p1_result[label] = probe_line(
            f"probe_unaligned [{label}]", readings[label], unaligned.window_bytes(o), 0,
            o.shape[0], card, f"{o.shape[0]} windows, {100 * aligned16:.1f}% of starts "
            f"16-byte aligned; equal to plain {exact}, two launches bit-equal {same}")
        if not (exact and same):
            fail(f"probe_unaligned [{label}] disagrees with its plain version")
    # Aligned against unaligned in turns (a, u, u, a), so that a change of
    # clock or of neighbours during the phase falls on both.
    turns = {"aligned-256": [], "unaligned": []}
    for label in ("aligned-256", "unaligned", "unaligned", "aligned-256"):
        o = offs[label]
        turns[label] += readings_ms(
            lambda: kernels.probe_unaligned(src, o, check_range=False), dev, 20)
    med_turns = {label: statistics.median(r) for label, r in turns.items()}
    log(f"# probe_unaligned in turns (aligned, unaligned, unaligned, aligned; 40 launches "
        f"each): aligned-256 median {med_turns['aligned-256']:.4f} ms (fastest "
        f"{min(turns['aligned-256']):.4f}), unaligned median {med_turns['unaligned']:.4f} ms "
        f"(fastest {min(turns['unaligned']):.4f}), unaligned / aligned "
        f"{med_turns['unaligned'] / med_turns['aligned-256']:.3f}; {card}")
    o = offs["unaligned"]
    o_long = o.long()
    plain_p1 = statistics.median(
        readings_ms(lambda: unaligned.copy_windows_plain(src, o), dev, 5))
    library_p1 = statistics.median(
        readings_ms(lambda: src.unfold(1, g, 1).index_select(1, o_long), dev, 20))
    log(f"# probe_unaligned [unaligned]: plain {plain_p1:.4f} ms, library index_select on "
        f"the unfold view (the transposed result) {library_p1:.4f} ms; {card}")
    med_p1, bound_p1 = p1_result["unaligned"]
    entries = [entry("probe_unaligned", 0.0, med_p1, plain_p1, bound_p1, library_p1)]
    del src, offs, got, again, want

    # P2: the probe's shapes, its all-ones inputs and seeded normal ones.
    t = outspec.T
    gen = torch.Generator(device=dev).manual_seed(1)
    normal = {"d": (torch.randn((t, outspec.N_PIX, 8), device=dev, generator=gen),
                    *(torch.randn((t, outspec.N_PIX, 1), device=dev, generator=gen)
                      for _ in range(3))),
              "e": (torch.randn((t, 16, outspec.N_PIX), device=dev, generator=gen),)}
    ones = outspec.probe_inputs(t, dev)

    def outputs(fn) -> tuple:
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    wide = torch.empty((t, 16, outspec.N_PIX), device=dev)
    narrow8 = torch.empty((t, outspec.N_PIX, 8), device=dev)
    narrow1 = torch.empty((t, outspec.N_PIX, 1), device=dev)
    narrow1i = torch.empty((t, outspec.N_PIX, 1), dtype=torch.int32, device=dev)
    fills = {"b": lambda: wide.fill_(1.0), "c": lambda: narrow8.fill_(1.0),
             "a1": lambda: narrow1.fill_(2.0), "ai": lambda: narrow1i.fill_(3)}
    fill_ms = {k: statistics.median(readings_ms(f, dev, 20)) for k, f in fills.items()}
    a_fills = fill_ms["c"] + fill_ms["a1"] + fill_ms["ai"]
    log(f"# outspec_a library yardstick: three fill_ calls {fill_ms['c']:.4f} + "
        f"{fill_ms['a1']:.4f} + {fill_ms['ai']:.4f} = {a_fills:.4f} ms (no single call); {card}")
    adds_per_px = {"d": 8 + 3, "e": 16}  # one add per input value into the tile's sum
    for key in "abcde":
        name = f"outspec_{key}"
        cases = [("ones", ones), ("normal", normal)] if key in normal else [("fill", ones)]
        err, notes = 0.0, []
        for kind, ins in cases:
            kernel = outspec.calls(t, dev, ins)[key]
            got, again = outputs(kernel), outputs(kernel)
            want = outputs(outspec.plain_calls(t, dev, ins)[key])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if key in normal:
                diff = (got[0] - want[0]).abs()
                limit = SUM_RTOL * sum(x.abs().sum((1, 2)) for x in ins[key])
                ok = bool((diff.amax((1, 2)) <= limit).all())
                if kind == "ones":
                    ok = ok and bool((got[0] == outspec.ONES_SUM[key]).all())
                err = max(err, diff.max().item())
                notes.append(f"{kind} inputs: max err {diff.max().item():.3g} (limit "
                             f"{SUM_RTOL:g} of each tile's sum of |x|, smallest "
                             f"{limit.min().item():.3g}), bit-equal {same}")
            else:
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
                notes.append(f"equal to plain {ok}, bit-equal {same}")
            if not (ok and same):
                fail(f"{name} ({kind}) disagrees with its plain version")
        plain = statistics.median(readings_ms(outspec.plain_calls(t, dev, ones)[key], dev, 5))
        library = fill_ms.get(key) if key in ("b", "c") else None
        med, bound = probe_line(name, p2[key], outspec.BYTES_PER_PIXEL[key] * t * outspec.N_PIX,
                                adds_per_px.get(key, 0) * t * outspec.N_PIX, t, card,
                                "; ".join(notes) + f"; plain {plain:.4f} ms, library "
                                + ("none" if library is None else f"fill_ {library:.4f} ms"))
        entries.append(entry(name, err, med, plain, bound, library))
    # P2a and P2b against the fill_ calls that write the same outputs, in
    # turns (kernel, fills, fills, kernel; 20 launches each), so that a change
    # of clock during the phase falls on both.
    kernel_calls = outspec.calls(t, dev, ones)
    rivals = {"a": (kernel_calls["a"], lambda: [fills[k]() for k in ("c", "a1", "ai")]),
              "b": (kernel_calls["b"], fills["b"])}
    for key, (kern, lib) in rivals.items():
        turns = {"kernel": [], "fill_": []}
        for who in ("kernel", "fill_", "fill_", "kernel"):
            fn = kern if who == "kernel" else lib
            turns[who].append(statistics.median(readings_ms(fn, dev, 20)))
        mean = {who: sum(r) / 2 for who, r in turns.items()}
        spread = max(abs(r[0] - r[1]) / mean[who] for who, r in turns.items())
        ratio = mean["kernel"] / mean["fill_"]
        log(f"# outspec_{key} in turns against {'three fill_ calls' if key == 'a' else 'fill_'}: "
            f"kernel medians {turns['kernel'][0]:.4f}, {turns['kernel'][1]:.4f} ms, fill_ "
            f"medians {turns['fill_'][0]:.4f}, {turns['fill_'][1]:.4f} ms; kernel / fill_ "
            f"{ratio:.3f}, spread of the turns {spread:.3f}: "
            f"{'slower beyond the spread' if ratio - 1 > spread else 'within the spread'}; "
            f"{card}")
    return entries


def fwd_agreement(got, again, want, far: float) -> tuple[str, bool, float]:
    """Kernel A's outputs `got` (and a second launch `again`) against its
    plain version's `want`, as phase 3 holds them: (the log's note, whether
    every check passed, the largest accum or tfinal difference)."""
    from ex4dgs_tpu_torch.ops.rasterize_cuda import TF_RTOL, tfinal_rel_err

    (acc_k, tf_k, idx_k), (acc_p, tf_p, idx_p) = got, want

    def depth_of(a):
        has = a[..., 7] > 0
        return torch.where(has, a[..., 3] / torch.where(has, a[..., 7], 1.0), far)

    err_acc = (acc_k - acc_p).abs().max().item()
    err_tf = (tf_k - tf_p).abs().max().item()
    rel_tf, n_latch = tfinal_rel_err(tf_k, tf_p)
    err_depth = (depth_of(acc_k) - depth_of(acc_p)).abs().max().item()
    agree = (idx_k == idx_p).float().mean().item()
    finite = all(bool(torch.isfinite(x).all()) for x in (acc_k, tf_k))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    note = (f"accum {err_acc:.3g} (atol 2e-5), tfinal {err_tf:.3g} (atol 2e-5; relative "
            f"{rel_tf:.3g}, rtol {TF_RTOL:g}, {n_latch} pixels on the latch left out), depth "
            f"{err_depth:.3g} (atol 1e-4), bestidx agreement {agree:.6f} (>= 0.999), finite "
            f"{finite}; two launches bit-equal {same}")
    ok = (finite and err_acc <= 2e-5 and err_tf <= 2e-5 and err_depth <= 1e-4
          and agree >= 0.999 and rel_tf <= TF_RTOL and same)
    return note, ok, max(err_acc, err_tf)


def bwd_agreement(got, again, want, twin, lo: int, hi: int,
                  spread=None) -> tuple[str, bool, float]:
    """Kernel B's dgrad `got` (and a second launch `again`) against its
    plain version's `want` and its twin's, as phase 5 holds it: (the log's
    note, whether every check passed, the largest difference from plain).
    Given `spread`, the plain version's own float32 spread on the frame
    (bwd_errors of it walked one instance at a time against `want`), a row
    group whose spread exceeds the BWD_RTOL/BWD_ATOL limit may differ from
    plain by up to HARD_FRAME_RATIO times that spread."""
    from ex4dgs_tpu_torch.ops.rasterize_cuda import BWD_ROWS, HARD_FRAME_RATIO, bwd_errors

    errs = bwd_errors(got, want, lo, hi)
    median = {}
    for name, rows in BWD_ROWS.items():
        mag = want[rows, lo:hi].abs()
        median[name] = mag[mag > 0].median().item() if bool((mag > 0).any()) else 0.0
    outside_zero = not (got[:, :lo].any() or got[:, hi:].any() or got[14:].any())
    bit_equal = torch.equal(got, again)
    finite = bool(torch.isfinite(got).all())
    twin_equal = torch.equal(got, twin)
    limit = {k: 1.0 if spread is None else max(1.0, HARD_FRAME_RATIO * spread[k][1])
             for k in errs}
    note = (", ".join(f"{k} max err {e[0]:.3g}, worst err/limit {e[1]:.3g} (<= {limit[k]:.3g}), "
                      f"floor {e[2]:.3g}, median non-zero |plain| {median[k]:.3g}"
                      for k, e in errs.items())
            + f"; outside the ranges zero {outside_zero}; two launches bit-equal {bit_equal}; "
            f"finite {finite}; bit-equal to its twin composite_tiles_bwd_walk {twin_equal}")
    ok = (finite and outside_zero and bit_equal and twin_equal
          and all(e[1] <= limit[k] for k, e in errs.items()))
    return note, ok, max(e[0] for e in errs.values())


def in_turns(runs: dict, reps: int = 20) -> dict:
    """CUDA-event ms per call of each of two callables, timed in turns (a,
    b, b, a; `reps` calls each turn): {name: (mean, first turn, second
    turn)}."""
    from ex4dgs_tpu_torch.bench_frame import cuda_ms

    names = list(runs)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cuda_ms(runs[n], reps))
    return {n: (sum(t) / 2, *t) for n, t in times.items()}


def subpixel_phase(dev, scene, bg, pairs_none, card: str) -> dict:
    """Phase 11: kernels A and B with subpixel offsets on the bench frame,
    then the subpixel render and backward path. Returns each kernel's
    subpixel numbers for the kernels line."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import bench_offsets, cotangents, cuda_ms, pack_frame
    from ex4dgs_tpu_torch.ops.rasterize_cuda import (composite_tiles_bwd_plain,
                                                     composite_tiles_bwd_walk,
                                                     composite_tiles_plain, tile_offsets,
                                                     warp_boxes)
    from ex4dgs_tpu_torch.rendering import render
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras

    model, cfg, cam, _, capacity = scene
    tx, ty = 32, 16
    data, gid, starts, stops, gx, n_points = pack_frame(scene, tx, ty)
    T, npix = starts.shape[0], tx * ty
    off_img = bench_offsets(dev)
    off = tile_offsets(off_img, gx, T // gx, tx, ty)
    args = (data, gid, starts, stops)
    kw = dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True)

    # -- kernel A with offsets against its plain version
    acc_k, tf_k, idx_k = got = kernels.composite_fwd(*args, **kw, offsets=off)
    again = kernels.composite_fwd(*args, **kw, offsets=off)
    want = composite_tiles_plain(*args, **kw, offsets=off)
    acc_n, tf_n, _ = kernels.composite_fwd(*args, **kw)
    torch.cuda.synchronize()
    note, ok, err_a = fwd_agreement(got, again, want, cfg.far)
    moved = (acc_k - acc_n).abs().max().item()
    log(f"# subpixel composite_fwd vs plain: {note}; accum moved by the offsets by up to "
        f"{moved:.3g}")
    if not (ok and moved > 1e-3):
        fail("composite_fwd with offsets disagrees with its plain version")
    if not bool((idx_k >= -1).all()) or int(idx_k.max().item()) >= n_points:
        fail("composite_fwd with offsets wrote an id outside [-1, P)")
    del got, again, want

    fwd_t = in_turns({"without": lambda: kernels.composite_fwd(*args, **kw),
                      "with": lambda: kernels.composite_fwd(*args, **kw, offsets=off)})
    plain_ms = cuda_ms(lambda: composite_tiles_plain(*args, **kw, offsets=off), reps=2,
                       warmup=1)
    pairs = walked_pairs(data, starts, stops, gx, tx, ty, offsets=off)
    span = {name: (b[..., 1] - b[..., 0]).mean().item() for name, b in (
        ("x", warp_boxes(gx, T, tx, ty, dev, offsets=off)[..., 0:2]),
        ("y", warp_boxes(gx, T, tx, ty, dev, offsets=off)[..., 2:4]))}
    n_inst = int(stops[-1].item() - starts[0].item())
    off_bytes = T * npix * 2 * 4
    nbytes = 14 * 4 * n_inst + 4 * n_inst + 2 * 4 * T + T * npix * (8 + 1 + 1) * 4 + off_bytes
    bound_a, by_a, (t_bytes, t_fp32, t_sfu) = bound_of(
        nbytes, SLOTS_EVAL * pairs["contributing"] + SLOTS_APPLIED * pairs["applied"],
        pairs["contributing"])
    steps = {k: (pairs_none[k] // 32, pairs[k] // 32) for k in ("warp_walked",
                                                                 "warp_walked_culled")}
    log(f"# subpixel composite_fwd: {fwd_t['with'][0]:.4f} ms/frame with offsets, "
        f"{fwd_t['without'][0]:.4f} without, in turns (without {fwd_t['without'][1]:.4f}, "
        f"with {fwd_t['with'][1]:.4f}, with {fwd_t['with'][2]:.4f}, without "
        f"{fwd_t['without'][2]:.4f}): with / without {fwd_t['with'][0] / fwd_t['without'][0]:.4f}"
        f"; plain {plain_ms:.2f} ms; lane-pairs with offsets evaluated {pairs['evaluated']}, "
        f"contributing {pairs['contributing']}, applied {pairs['applied']} (without: "
        f"{pairs_none['evaluated']}, {pairs_none['contributing']}, {pairs_none['applied']}); "
        f"warp steps without the cull {steps['warp_walked'][1]} (without offsets "
        f"{steps['warp_walked'][0]}), with the offset-aware cull's twin "
        f"{steps['warp_walked_culled'][1]} (the integer box without offsets "
        f"{steps['warp_walked_culled'][0]}), {pairs['dropped']} contributing pairs dropped; "
        f"the cull's warp box spans {span['x']:.3f} x {span['y']:.3f} pixel-widths on "
        f"average (31 x 0 without offsets); "
        f"bound {bound_a:.4f} ms (bytes {t_bytes:.4f} with {off_bytes / 1e6:.2f} MB of "
        f"offsets, fp32 {t_fp32:.4f}, sfu {t_sfu:.4f}); {card}")
    if pairs["dropped"]:
        fail(f"the offset-aware cull's twin skips {pairs['dropped']} contributing pairs")
    if fwd_t["with"][0] < bound_a:
        fail(f"composite_fwd with offsets read {fwd_t['with'][0]:.4f} ms, below its bound")

    # -- kernel B with offsets against its twin and its plain version
    gacc, acdot, gend = cotangents(acc_k)
    bargs = (data, starts, stops, gacc, acdot, gend, tf_k)
    bkw = dict(grid_x=gx, tile_x=tx, tile_y=ty, offsets=off)
    d_k = kernels.composite_bwd(*bargs, **bkw)
    d_k2 = kernels.composite_bwd(*bargs, **bkw)
    d_p = composite_tiles_bwd_plain(*bargs, **bkw)
    torch.cuda.synchronize()
    note, ok, err_b = bwd_agreement(d_k, d_k2, d_p, composite_tiles_bwd_walk(*bargs, **bkw),
                                    int(starts[0].item()), int(stops[-1].item()))
    log(f"# subpixel composite_bwd vs plain: {note}")
    if not ok:
        fail("composite_bwd with offsets disagrees with its plain version or its twin")
    del d_k2, d_p
    gacc_n, acdot_n, gend_n = cotangents(acc_n)
    nargs = (data, starts, stops, gacc_n, acdot_n, gend_n, tf_n)
    nkw = dict(grid_x=gx, tile_x=tx, tile_y=ty)
    bwd_t = in_turns({"without": lambda: kernels.composite_bwd(*nargs, **nkw),
                      "with": lambda: kernels.composite_bwd(*bargs, **bkw)})
    plain_b = cuda_ms(lambda: composite_tiles_bwd_plain(*bargs, **bkw), reps=2, warmup=1)
    nbytes_b = (14 + 16) * 4 * n_inst + 2 * 4 * T + T * npix * (8 + 3) * 4 + off_bytes
    bound_b, by_b, (tb_bytes, tb_fp32, tb_sfu) = bound_of(
        nbytes_b, SLOTS_EVAL_B * pairs["contributing"] + SLOTS_APPLIED_B * pairs["applied"],
        pairs["contributing"] + pairs["applied"])
    log(f"# subpixel composite_bwd: {bwd_t['with'][0]:.4f} ms/frame with offsets, "
        f"{bwd_t['without'][0]:.4f} without, in turns (without {bwd_t['without'][1]:.4f}, "
        f"with {bwd_t['with'][1]:.4f}, with {bwd_t['with'][2]:.4f}, without "
        f"{bwd_t['without'][2]:.4f}): with / without {bwd_t['with'][0] / bwd_t['without'][0]:.4f}"
        f"; plain {plain_b:.2f} ms; warp steps with an applied lane {pairs['steps_applied']} "
        f"(without offsets {pairs_none['steps_applied']}); bound {bound_b:.4f} ms (bytes "
        f"{tb_bytes:.4f}, fp32 {tb_fp32:.4f}, sfu {tb_sfu:.4f}); {card}")
    if bwd_t["with"][0] < bound_b:
        fail(f"composite_bwd with offsets read {bwd_t['with'][0]:.4f} ms, below its bound")
    del bargs, nargs, gacc, acdot, gend, gacc_n, acdot_n, gend_n, d_k, acc_k, tf_k, idx_k
    del acc_n, tf_n, data, gid, off

    # -- the subpixel main path: renders, and one backward through a render
    def frame(t, m=model):
        return render(cam, m, cfg, t=t, bg=bg, capacity=capacity, subpixel_offset=off_img,
                      device=dev)

    frame(1.0)  # warm-up
    torch.cuda.synchronize()
    render_counts = dict.fromkeys(kernels.launches, 0)
    for t in (0.0, 1.0, 2.5):
        kernels.reset_launches()
        res = frame(t)
        torch.cuda.synchronize()
        if kernels.launches != {**render_counts, "composite_fwd": 1}:
            fail(f"subpixel render t={t} launched {dict(kernels.launches)}, expected one A")
        render_counts["composite_fwd"] += 1
        tot = int(res.binning_total.item())
        outs = (res.render, res.depth, res.opticalflow, res.acc)
        if tot > capacity or not all(bool(torch.isfinite(o).all()) for o in outs):
            fail(f"subpixel render t={t}: overflow ({tot} > {capacity}) or non-finite output")
        if tuple(res.render.shape) != (cam.height, cam.width, 3) or float(res.acc.max()) <= 0:
            fail(f"subpixel render t={t}: wrong shape or all background")
        log(f"# subpixel render t={t}: {tot} instances, acc mean {res.acc.mean().item():.4f}")
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
    kernels.reset_launches()
    res = frame(1.0, model.replace(params=leaves))
    loss = res.render.abs().mean()
    loss.backward()
    torch.cuda.synchronize()
    backward_counts = dict(kernels.launches)
    grads = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    finite_g = all(bool(torch.isfinite(g).all()) for g in grads.values())
    nonzero = sum(int((g != 0).any()) for g in grads.values())
    log(f"# subpixel main path: 3 renders launched {render_counts}; one loss.backward() "
        f"through a render launched {backward_counts}; loss {loss.item():.6f}, gradients of "
        f"{len(grads)} params, {nonzero} non-zero, finite {finite_g}")
    want = dict.fromkeys(render_counts, 0)
    if backward_counts != {**want, "composite_fwd": 1, "composite_bwd": 1}:
        fail(f"the subpixel backward launched {backward_counts}, expected one of A and B")
    if not (finite_g and nonzero > 0):
        fail("the subpixel backward gave non-finite or all-zero gradients")
    del leaves, grads, res, loss

    # -- phase 9's small scene with offsets, card against CPU
    small, small_g = {}, {}
    off_small = bench_offsets("cpu")[:96, :160].contiguous()
    for d in ("cuda", "cpu"):
        m_s, c_s = make_scene(n_static=3000, n_dynamic=300, duration=10.0, seed=1, device=d)
        cam_s = ring_cameras(1, 3.0, 160, 96, far=c_s.far, device=d)[0]
        bg_s = torch.tensor([0.1, 0.2, 0.3]).to(d)
        leaves = {k: v.detach().requires_grad_(True) for k, v in m_s.params.items()}
        small[d] = render(cam_s, m_s.replace(params=leaves), c_s, t=2.5, bg=bg_s,
                          capacity=65536, subpixel_offset=off_small.to(d), device=d)
        (small[d].render - 0.5).abs().mean().backward()
        small_g[d] = {k: v.grad.cpu() for k, v in leaves.items() if v.grad is not None}
    g, c = small["cuda"], small["cpu"]
    err_small = (g.render.detach().cpu() - c.render.detach()).abs().max().item()
    err_small_acc = (g.acc.cpu() - c.acc).abs().max().item()
    agree_s = (g.dominent_idxs.cpu() == c.dominent_idxs).float().mean().item()
    grad_rel = max((small_g["cuda"][k] - small_g["cpu"][k]).abs().max().item()
                   / max(small_g["cpu"][k].abs().max().item(), 1e-30)
                   for k in small_g["cpu"] if small_g["cpu"][k].abs().max().item() > 0)
    log(f"# small scene 160x96 with offsets, cuda vs cpu: color {err_small:.3g}, acc "
        f"{err_small_acc:.3g} (atol 1e-4), idx agreement {agree_s:.5f} (>= 0.99), gradients "
        f"{grad_rel:.3g} of their largest (<= 1e-3)")
    if not (err_small <= 1e-4 and err_small_acc <= 1e-4 and agree_s >= 0.99
            and grad_rel <= 1e-3):
        fail("the card's subpixel render or gradients of the small scene disagree with the CPU's")
    return {
        "composite_fwd": {"subpixel_launches": render_counts["composite_fwd"]
                          + backward_counts["composite_fwd"], "subpixel_ms": fwd_t["with"][0],
                          "subpixel_ms_without_offsets": fwd_t["without"][0],
                          "subpixel_plain_ms": plain_ms, "subpixel_bound_ms": bound_a,
                          "subpixel_bound_by": by_a, "subpixel_max_abs_err": err_a},
        "composite_bwd": {"subpixel_launches": backward_counts["composite_bwd"],
                          "subpixel_ms": bwd_t["with"][0],
                          "subpixel_ms_without_offsets": bwd_t["without"][0],
                          "subpixel_plain_ms": plain_b, "subpixel_bound_ms": bound_b,
                          "subpixel_bound_by": by_b, "subpixel_max_abs_err": err_b},
    }


# Phase 12: the N3V config with only the schedule shortened, so that 150
# iterations cross every event kind the schedule reaches before iteration
# 3000 (tests/test_trainer.py's schedule); resolution and point count uncut.
TRAIN_SCHEDULE = ["--start_duration", "2", "--time_interval", "2", "--time_pad", "1",
                  "--densify_from_iter", "20", "--densification_interval", "30",
                  "--extract_from_iter", "20", "--progressive_growing_steps", "40",
                  "--make_dynamic_interval", "10", "--extracton_interval", "60"]
TRAIN_ITERS, RESUME_ITERS = 150, 10
SCHEDULED_KINDS = ("densify_and_prune", "adjust_temp_opa", "expand_duration",
                   "extract_dynamic_from_static")
# Reached only after iteration 3000 (prune_invisible, prune_small), on a NaN
# (prune_nan) or never by the reference's loop (reset_opacity): timed on the
# saved checkpoint's model instead.
UNSCHEDULED_KINDS = ("prune_invisible", "prune_small", "prune_nan", "reset_opacity")


def run_cli(args: list, root: str, timeout: int) -> dict:
    """python -m ex4dgs_tpu_torch.train with `args`, from the repo root, as
    a user runs it; returns its train_report.json."""
    model_path = args[args.index("--model_path") + 1]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ex4dgs_tpu_torch.train", *args], cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        log(out.stdout[-3000:])
        log(out.stderr[-6000:])
        fail(f"the training CLI exited {out.returncode}")
    with open(os.path.join(model_path, "train_report.json")) as f:
        report = json.load(f)
    report["wall_s"] = wall
    return report


def check_launches(what: str, report: dict) -> None:
    """Kernel A once per train_step (iterations, plus one per overflow
    retry), per test render and per viewer request served; kernel B once
    per iteration; no other kernel."""
    first, last = report["iterations"]
    iters = last - first + 1
    want = {"composite_fwd": (iters + report["overflow_retries"] + report["test_renders"]
                              + report["gui_renders"]),
            "composite_bwd": iters}
    got = report["kernel_launches"]
    if got != {**dict.fromkeys(got, 0), **want}:
        fail(f"{what}: kernel launches {got}, the schedule implies {want}")


def trainer_report_lines(what: str, report: dict, card: str) -> None:
    iter_ms = report["iter_ms"]
    ev = report["event_iterations"]
    log(f"# {what}: iterations {report['iterations'][0]}-{report['iterations'][1]}, "
        f"{report['wall_s']:.1f} s of process wall time; host clock {report['ms_per_iteration']:.3f} "
        f"ms/iteration over the whole loop, {report['ms_per_iteration_without_events']:.3f} "
        f"without the {len(ev)} event iterations {ev}; median "
        f"{statistics.median(iter_ms):.3f}, slowest {max(iter_ms):.1f}; train_step calls "
        f"{report['steps']} ({report['overflow_retries']} overflow retries, capacity now "
        f"{report['capacity']}), test renders {report['test_renders']}; launches "
        f"{report['kernel_launches']}; {card}")
    for kind, times in sorted(report["event_ms"].items()):
        log(f"#   event {kind}: x{len(times)}, numpy ms " + ", ".join(f"{t:.1f}" for t in times))
    log("#   pull ms " + ", ".join(f"{t:.1f}" for t in report["pull_ms"])
        + "; push ms " + ", ".join(f"{t:.1f}" for t in report["push_ms"]))
    log("#   after each event (iteration, kind, n_static, n_dynamic): "
        + "; ".join(f"{it} {kind} {ns} {nd}" for it, kind, ns, nd in report["event_log"]))
    loss, psnr = np.asarray(report["loss"]), np.asarray(report["psnr"])
    windows = range(0, len(loss), 30)
    log("#   loss / psnr by 30 iterations: " + "; ".join(
        f"{report['iterations'][0] + w}-{report['iterations'][0] + min(w + 30, len(loss)) - 1} "
        f"{loss[w:w + 30].mean():.5f} / {psnr[w:w + 30].mean():.2f} dB (t <= "
        f"{max(report['timestamps'][w:w + 30]):g})" for w in windows))
    gt = report["gt_cache"]
    log(f"#   GT cache: {gt['hits']} hits, {gt['decodes']} decodes (PIL, mean "
        f"{statistics.mean(gt['decode_ms'] or [0]):.1f} ms each in a worker thread; upload mean "
        f"{statistics.mean(gt['upload_ms'] or [0]):.2f} ms), {gt['bytes'] / 2**20:.1f} MiB on the "
        f"device; scene read in {report['scene_s']:.2f} s, trainer built (points, KNN scales, "
        f"the first event) in {report['init_s']:.2f} s; save (PLYs, checkpoint, digest) ms "
        + ", ".join(f"{t:.0f}" for t in report["save_ms"])
        + f"; test reports {report['test_reports']}")


def trainer_kernels_hold(dev, model, cfg, capacity: int, card: str) -> dict:
    """Kernels A and B on the trainer path's own inputs: the saved model
    (static and dynamic rows) seen by one train camera at its timestamp,
    packed into the trainer's instance capacity at the trainer's tile, each
    kernel against its plain version on those inputs (kernel B with seeded
    cotangents). Kernel A is held as phase 3 holds it. Kernel B is held
    bit-equal to its twin and within BWD_RTOL/BWD_ATOL of plain, or, in a
    row group where the plain version walked one instance at a time does
    not meet that limit against itself, within HARD_FRAME_RATIO times its
    spread (bwd_agreement's `spread`). Returns each kernel's largest
    difference from its plain version."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import cotangents, pack_view
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.ops.rasterize_cuda import (bwd_errors, composite_tiles_bwd_plain,
                                                     composite_tiles_bwd_walk,
                                                     composite_tiles_plain)

    cams = Scene(cfg).train_cameras
    cam = cams[len(cams) // 2]
    kcfg = KernelConfig()
    tx, ty = kcfg.tile_x, kcfg.tile_y
    data, gid, starts, stops, gx, n_points = pack_view(
        model, cfg, cam.render_camera(dev), cam.timestamp, capacity, tx, ty)
    args, kw = (data, gid, starts, stops), dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True)
    got = kernels.composite_fwd(*args, **kw)
    again = kernels.composite_fwd(*args, **kw)
    want = composite_tiles_plain(*args, **kw)
    note_a, ok_a, err_a = fwd_agreement(got, again, want, cfg.far)
    gacc, acdot, gend = cotangents(got[0])
    bargs = (data, starts, stops, gacc, acdot, gend, got[1])
    bkw = dict(grid_x=gx, tile_x=tx, tile_y=ty)
    d_k = kernels.composite_bwd(*bargs, **bkw)
    d_k2 = kernels.composite_bwd(*bargs, **bkw)
    d_p = composite_tiles_bwd_plain(*bargs, **bkw)
    twin = composite_tiles_bwd_walk(*bargs, **bkw)
    lo, hi = int(starts[0].item()), int(stops[-1].item())
    # The frame's float32 spread: the plain version walked one instance at a
    # time against itself at its chunk of 64 (1 = the BWD_RTOL/BWD_ATOL limit).
    spread = bwd_errors(composite_tiles_bwd_plain(*bargs, chunk=1, **bkw), d_p, lo, hi)
    note_b, ok_b, err_b = bwd_agreement(d_k, d_k2, d_p, twin, lo, hi, spread=spread)
    longest = int((stops - starts).max().item())
    log(f"# trainer path, saved model through {cam.image_name} at t={cam.timestamp:g} "
        f"({cam.width}x{cam.height}, {n_points} rows, {hi - lo} instances in capacity "
        f"{capacity}, tile {tx}x{ty}, longest tile {longest}): composite_fwd vs plain: "
        f"{note_a}; composite_bwd vs plain: {note_b}; the plain version at chunk=1 against "
        f"itself at chunk=64, worst err/limit: "
        + ", ".join(f"{k} {e[1]:.3g}" for k, e in spread.items()) + f"; {card}")
    if not (ok_a and ok_b):
        fail("a kernel disagrees with its plain version on the trainer path's inputs")
    return {"composite_fwd": err_a, "composite_bwd": err_b}


def trainer_phase(dev, card: str, tmp: str) -> tuple[dict, str, dict]:
    """Phase 12: the training entry point at full width through a whole
    (shortened) schedule, the kernels against their plain versions on its
    saved model, a resume, the events the schedule does not reach, and the
    trainer on a tiny scene on the card against the CPU. The scene and the
    model go to `tmp`. Returns kernels A and B's launches in the trainer's
    runs and their largest difference from the plain versions on the saved
    model, the model directory, and the first run's train_report.json."""
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
    from ex4dgs_tpu_torch.io.checkpoint import digest, load_checkpoint
    from ex4dgs_tpu_torch.models import density as D
    from ex4dgs_tpu_torch.models.config import ModelConfig, overlay_json

    root = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(root, "configs", "N3V", "n3v_base.json")
    scene = os.path.join(tmp, "scene")
    t0 = time.perf_counter()
    write_n3v_scene(scene, n_cams=4, n_frames=8, n_points=100_000, seed=0)
    log(f"# trainer path: wrote a seeded N3V scene (4 cameras x 8 frames of 2704x2028 PNG, "
        f"100000 points) in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "model")
    base = ["--config", config, "--source_path", scene, "--model_path", out, "--quiet",
            *TRAIN_SCHEDULE]
    first = run_cli(base + ["--iterations", str(TRAIN_ITERS), "--save_iterations",
                            str(TRAIN_ITERS), "--test_iterations", str(TRAIN_ITERS)],
                    root, 900)
    trainer_report_lines(f"trainer path ({TRAIN_ITERS} iterations, config {config})",
                         first, card)
    losses = np.asarray(first["loss"])
    if losses.shape != (TRAIN_ITERS,) or not np.isfinite(losses).all():
        fail(f"trainer path: {losses.shape[0]} losses, finite {np.isfinite(losses).all()}")
    early, late = losses[:10].mean(), losses[-10:].mean()
    log(f"# trainer path: loss {early:.6f} (mean of the first 10) -> {late:.6f} (last 10); "
        f"psnr {np.mean(first['psnr'][:10]):.3f} -> {np.mean(first['psnr'][-10:]):.3f} dB")
    if not late < early:
        fail("trainer path: the loss did not fall")
    missing = [k for k in SCHEDULED_KINDS if first["event_counts"].get(k, 0) == 0]
    if missing or first["event_counts"]["expand_duration"] < 2:  # one at construction
        fail(f"trainer path: event kinds that never ran {missing}; counts "
             f"{first['event_counts']}")
    check_launches("trainer path", first)
    if first["test_renders"] == 0 or first["gt_cache"]["hits"] == 0:
        fail("trainer path: no test render or no GT cache hit")

    # the saved files, and the checkpoint reloaded bit-equal on the card
    ply = os.path.join(out, "point_cloud", f"iteration_{TRAIN_ITERS}", "point_cloud.ply")
    ckpt = os.path.join(out, f"chkpnt{TRAIN_ITERS}.npz")
    if not (os.path.exists(ply) and os.path.exists(ckpt)):
        fail("trainer path: the PLY or the checkpoint is missing")
    cfg = overlay_json(ModelConfig(), os.path.join(out, "cfg_args.json"))  # the CLI's
    hm, it, _ = load_checkpoint(ckpt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state = D.push(hm, cfg, device=dev)
    torch.cuda.synchronize()
    push_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = D.pull(model, state)
    pull_ms = (time.perf_counter() - t0) * 1e3
    saved = first["saved"][str(TRAIN_ITERS)]
    reload_ok = digest(hm) == saved and digest(back) == saved and it == TRAIN_ITERS
    log(f"# trainer path: checkpoint {os.path.getsize(ckpt) / 2**20:.1f} MiB, "
        f"{hm.n_static} static + {hm.n_dynamic} dynamic rows, keyframes {hm.keyframe_num}; "
        f"push(load_checkpoint) on the card {push_ms:.1f} ms, pull {pull_ms:.1f} ms; "
        f"bit-equal to the trainer's pull at save {reload_ok}")
    if not reload_ok:
        fail("trainer path: the checkpoint does not reload bit-equal")
    errs = trainer_kernels_hold(dev, model, cfg, first["capacity"], card)

    # the event kinds the schedule does not reach, on the saved model
    timed = {}
    for kind in UNSCHEDULED_KINDS:
        h = D.pull(model, state)
        t0 = time.perf_counter()
        getattr(D, kind)(h)
        timed[kind] = ((time.perf_counter() - t0) * 1e3, h.n_static, h.n_dynamic)
    log("# trainer path: unscheduled events on the saved model (numpy ms, n_static, "
        "n_dynamic after): " + "; ".join(f"{k} {t:.1f} ms {ns} {nd}"
                                        for k, (t, ns, nd) in timed.items()))
    del model, state, back

    resumed = run_cli(base + ["--iterations", str(TRAIN_ITERS + RESUME_ITERS),
                              "--start_checkpoint", ckpt], root, 600)
    trainer_report_lines("trainer path, resumed", resumed, card)
    if (resumed["iterations"] != [TRAIN_ITERS + 1, TRAIN_ITERS + RESUME_ITERS]
            or not np.isfinite(resumed["loss"]).all()):
        fail(f"trainer path: the resumed run took iterations {resumed['iterations']}, "
             f"losses finite {np.isfinite(resumed['loss']).all()}")
    check_launches("trainer path, resumed", resumed)

    small = small_trainer_check(dev, card)
    return {name: {"trainer_launches": first["kernel_launches"][name]
                   + resumed["kernel_launches"][name] + small[name],
                   "trainer_max_abs_err": errs[name]}
            for name in ("composite_fwd", "composite_bwd")}, out, first


def small_trainer_check(dev, card: str) -> dict:
    """The trainer on a tiny on-disk scene (the CPU tests' size) on the
    card and on the CPU, for the 20 iterations before its first event:
    losses within rtol 1e-5 (tests/test_torch_train.py's step tolerance,
    phase 9's for the loss of one step on the card against the CPU).
    Then the card's run on through its 120-iteration schedule, where the
    cloud outgrows its static capacity (the growth branch of the capacity
    policy, which the full-width run does not reach), and a forced
    overflow on the card (starting capacity 256): the same first loss as
    the run that never overflowed, and one more launch of kernel A per
    retry. Returns the card runs' launches."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
    from ex4dgs_tpu_torch.data.readers import read_n3v_scene
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
    from ex4dgs_tpu_torch.train.trainer import Trainer

    n = 20
    launched = dict.fromkeys(kernels.launches, 0)
    with tempfile.TemporaryDirectory(prefix="ex4dgs_small_") as root:
        write_n3v_scene(root, n_cams=4, n_frames=6, n_points=300, width=640, height=480, seed=1)
        cfg = ModelConfig(source_path=root, loader="neural3dvideo", resolution=8, duration=-1,
                          time_interval=2, time_pad=1, start_duration=2, near=0.05, far=50.0)
        opt = OptimizationConfig(iterations=120, densification_interval=20,
                                 densify_from_iter=10, extract_from_iter=20,
                                 densify_until_iter=1000, progressive_growing_steps=40,
                                 make_dynamic_interval=10, extracton_interval=60,
                                 prune_invisible_interval=100000, random_background=True)
        runs = {}
        for d, cap, iters in (("cuda", 65536, n), ("cpu", 65536, n), ("cuda", 256, 3)):
            tr = Trainer(cfg, opt, Scene(cfg, scene_info=read_n3v_scene(root, cfg)),
                         capacity=cap, seed=11, device=d)
            kernels.reset_launches()
            metrics = tr.train(iterations=iters)
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            if d == "cuda":
                launched = {k: launched[k] + counts[k] for k in launched}
            runs[(d, cap)] = (metrics, counts, tr.overflow_count, list(tr.event_log))
            if (d, cap) == ("cuda", 65536):
                rest = tr  # goes on below
            else:
                tr.close()

        # The card's run through the rest of the schedule: the cloud grows
        # past its static capacity here (it does not at full width).
        sc0, steps0 = rest.model.static_capacity, rest.steps
        kernels.reset_launches()
        tail = rest.train(iterations=opt.iterations)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        launched = {k: launched[k] + counts[k] for k in launched}
        sc1, steps = rest.model.static_capacity, rest.steps - steps0
        tail_log = rest.event_log[len(runs[("cuda", 65536)][3]):]
        rest.close()
    log(f"# small trainer on the card, iterations {n + 1}-{opt.iterations}: static capacity "
        f"{sc0} -> {sc1}, after each event (iteration, kind, n_static, n_dynamic): "
        + "; ".join(f"{it} {kind} {ns} {nd}" for it, kind, ns, nd in tail_log)
        + f"; launches {counts}; losses finite {np.isfinite(tail['loss']).all()}")
    if not (sc1 > sc0 and np.isfinite(tail["loss"]).all()
            and counts == {**dict.fromkeys(counts, 0), "composite_fwd": steps,
                           "composite_bwd": opt.iterations - n}):
        fail("the small trainer's static capacity did not grow on the card, or its run "
             "through the schedule was not finite or launched other than A per step and B "
             "per iteration")
    (g, gc, _, glog), (c, cc, _, _) = runs[("cuda", 65536)], runs[("cpu", 65536)]
    rel = np.abs(np.asarray(g["loss"]) - np.asarray(c["loss"])) / np.abs(np.asarray(c["loss"]))
    same_bg = all(np.array_equal(a, b) for a, b in zip(g["backgrounds"], c["backgrounds"]))
    same_t = g["timestamps"] == c["timestamps"]
    log(f"# small trainer, cuda vs cpu, {n} iterations before the first event (at "
        f"{glog[-1][0]}): loss relative difference max {rel.max():.3g}, median "
        f"{np.median(rel):.3g} (rtol 1e-5); same timestamps {same_t}, same backgrounds "
        f"{same_bg}; card launches {gc}")
    if not (rel.max() <= 1e-5 and same_bg and same_t):
        fail("the trainer on the card disagrees with the CPU on the small scene")
    if gc != {**dict.fromkeys(gc, 0), "composite_fwd": n, "composite_bwd": n} or any(cc.values()):
        fail(f"small trainer launches: card {gc}, cpu {cc}")
    o, oc, retries, _ = runs[("cuda", 256)]
    log(f"# forced overflow on the card (capacity 256): {retries} retries, launches {oc}, "
        f"first loss {o['loss'][0]!r} against {g['loss'][0]!r} without the overflow; {card}")
    if not (retries >= 1 and oc["composite_fwd"] == 3 + retries and oc["composite_bwd"] == 3
            and o["loss"][0] == g["loss"][0] and o["timestamps"] == g["timestamps"][:3]):
        fail("the forced overflow did not grow and re-run the same camera once per retry")
    return launched


# Phase 13: the eval and viewer paths on phase 12's model and on the
# surface scene of tools/tpu_probes/_tpu_quality2.py (800x600, 19 cameras).
EVAL_ITERATION, EVAL_FPS_INNER, EVAL_FPS_ROUNDS = TRAIN_ITERS, 100, 20
MEAN_KEYS = ("PSNR", "SSIM", "SKSSIM", "SKSSIM2", "LPIPS", "LPIPSVGG", "times")
LPIPS_RTOL, LPIPS_ATOL = 1e-4, 1e-6  # tests/test_eval_metrics.py's LPIPS tolerance
IMAGE_TOL = 3e-5  # tests/test_pallas.py's image tolerance
VIEWER_TIMESTAMPS = (0.0, 2.5, 5.0)
SURFACE_W, SURFACE_H, SURFACE_CAMS = 800, 600, 19


def lpips_random_weights(net: str, seed: int) -> dict:
    """Seeded random weights in the LPIPS npz layout (conv{i}_w, conv{i}_b,
    lin{i}_w) for the port's layer table of `net`: they exercise the
    metric's arithmetic, they are not LPIPS."""
    from ex4dgs_tpu_torch.eval.lpips import LAYERS

    rng = np.random.default_rng(seed)
    w, cin, ci, li = {}, 3, 0, 0
    for spec in LAYERS[net]:
        if spec[0] == "conv":
            o, k = spec[1], spec[2]
            w[f"conv{ci}_w"] = rng.normal(scale=math.sqrt(2.0 / (cin * k * k)),
                                          size=(o, cin, k, k)).astype(np.float32)
            w[f"conv{ci}_b"] = rng.normal(scale=0.05, size=(o,)).astype(np.float32)
            cin, ci = o, ci + 1
        elif spec[0] == "tap":
            w[f"lin{li}_w"] = np.abs(rng.normal(size=(cin,))).astype(np.float32)
            li += 1
    return w


def load_trained(dev, model_dir: str, iteration: int):
    """(model on dev, cfg, scene sampled as the render CLI samples it)."""
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.io.checkpoint import load_checkpoint
    from ex4dgs_tpu_torch.models import density as D
    from ex4dgs_tpu_torch.models.config import ModelConfig, overlay_json

    cfg = overlay_json(ModelConfig(), os.path.join(model_dir, "cfg_args.json"))
    scene = Scene(cfg, model_path=model_dir)
    hm, _, _ = load_checkpoint(os.path.join(model_dir, f"chkpnt{iteration}.npz"))
    model, _ = D.push(hm, cfg, device=dev)
    scene.set_sampling_len(hm.duration)
    return model, cfg, scene


def eval_cli_check(model_dir: str, trained: dict, scene, fps_phase4: dict,
                   weights_dir: str, card: str) -> int:
    """13.1: the render CLI on phase 12's model, both splits at full width,
    with the seeded random LPIPS weights. Returns kernel A's launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "EX4DGS_LPIPS_WEIGHTS": weights_dir}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ex4dgs_tpu_torch.render_cli", "--model_path",
                          model_dir, "--iteration", str(EVAL_ITERATION), "--fps_inner",
                          str(EVAL_FPS_INNER)], cwd=root, env=env, capture_output=True,
                         text=True, timeout=900)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        log(out.stdout[-3000:])
        log(out.stderr[-6000:])
        fail(f"the render CLI exited {out.returncode}")
    reports = {r["split"]: r for r in (json.loads(line[len("eval_report "):])
                                       for line in out.stdout.splitlines()
                                       if line.startswith("eval_report "))}
    want_frames = {"test": len(scene.sampled_test_cameras()),
                   "train": len(scene.sampled_train_cameras())}
    cam0 = scene.sampled_test_cameras()[0]
    size = f"{cam0.width}x{cam0.height}"
    launched = 0
    means, rows_of = {}, {}
    for split in ("test", "train"):
        d = os.path.join(model_dir, split, f"ours_{EVAL_ITERATION}")
        with open(os.path.join(d, "mean_metrics.json")) as f:
            mean = means[split] = json.load(f)
        with open(os.path.join(d, "all_metrics_rows.json")) as f:
            rows = rows_of[split] = json.load(f)
        rep = reports.get(split)
        if rep is None or mean["n_frames"] != want_frames[split] or len(rows) != mean["n_frames"]:
            fail(f"render CLI, {split}: {mean['n_frames']} frames, the scene samples "
                 f"{want_frames[split]}; report {rep is not None}")
        keys = MEAN_KEYS if split == "test" else MEAN_KEYS[:-1]
        values = [mean.get(k) for k in keys] + [r[k] for r in rows for k in
                                                 ("psnr", "ssim", "ssim_sk", "ssim_sk2",
                                                  "lpips_alex", "lpips_vgg")]
        if not all(v is not None and math.isfinite(v) for v in values):
            fail(f"render CLI, {split}: a metric is missing or not finite: "
                 f"{ {k: mean.get(k) for k in keys} }")
        tm = rep["timings"]
        implied = mean["n_frames"] + tm["overflow_retries"]
        if split == "test":  # the probe render, the recipe, one round at the capacity
            implied += 1 + EVAL_FPS_ROUNDS * EVAL_FPS_INNER + EVAL_FPS_INNER
        got = rep["kernel_launches"]
        if got != {**dict.fromkeys(got, 0), "composite_fwd": implied}:
            fail(f"render CLI, {split}: launches {got}, the recipe implies composite_fwd "
                 f"{implied}")
        launched += implied
        st = {k: statistics.mean(v) for k, v in tm["stage_ms"].items()}
        log(f"# render CLI, {split} split ({mean['n_frames']} frames at {size}): PSNR "
            f"{mean['PSNR']:.4f} dB, SSIM {mean['SSIM']:.5f}, SKSSIM {mean['SKSSIM']:.5f}, "
            f"SKSSIM2 {mean['SKSSIM2']:.5f}; LPIPS {mean['LPIPS']:.5f}, LPIPSVGG "
            f"{mean['LPIPSVGG']:.5f} (seeded random weights, not LPIPS); capacity "
            f"{tm['capacity']} ({tm['overflow_retries']} overflow retries); host ms per frame: "
            f"render {st['render']:.2f}, GT load {st['gt_load']:.1f}, PSNR+SSIM "
            f"{st['psnr_ssim']:.2f}, ssim_skimage {st['ssim_sk']:.1f} (data range 1) and "
            f"{st['ssim_sk2']:.1f} (2), LPIPS alex {st['lpips_alex']:.2f}, vgg "
            f"{st['lpips_vgg']:.2f}; launches {got['composite_fwd']} = implied; {card}")
        if split == "test":
            log(f"# render CLI FPS recipe ({EVAL_FPS_ROUNDS} x {EVAL_FPS_INNER} calls at the "
                f"snug capacity {tm['snug_capacity']}, warm-up dropped): "
                f"{mean['times'] * 1e3:.3f} ms/frame, {mean['fps']:.1f} FPS, "
                f"{mean['mpixels_per_s']:.2f} Mpix/s; one round at the capacity "
                f"{tm['capacity']}: {tm['fps_ms_at_capacity']:.3f} ms/frame; phase 4's FPS "
                f"recipe on the bench scene: {fps_phase4[True]:.3f} (track_idx=True), "
                f"{fps_phase4[False]:.3f} (False) ms/frame; the CLI took {wall:.1f} s; {card}")
    # The trainer's test report renders the first (at most 8) test cameras of
    # its sampling window; the CLI samples to the model's duration, which
    # may reach further. Both lists are the scene's test cameras in the same
    # order, so the trainer's frames are the first rows of the CLI's. The
    # report is taken before the iteration's scheduled events, the
    # checkpoint after them (the JAX trainer's order), so the two models
    # are the same only where no event ran at that iteration.
    (it, rep), = [r for r in trained["test_reports"] if r[0] == EVAL_ITERATION]
    n = rep["n_frames"]
    prefix = float(np.mean([r["psnr"] for r in rows_of["test"][:n]]))
    diff = abs(prefix - rep["psnr"])
    events = [kind for i, kind, _, _ in trained["event_log"] if i == it]
    log(f"# render CLI test PSNR {means['test']['PSNR']!r} over its {means['test']['n_frames']} "
        f"frames (t <= {max(r['timestamp'] for r in rows_of['test']):g}), {prefix!r} over the "
        f"trainer's {n} (t <= {rows_of['test'][n - 1]['timestamp']:g}); the trainer's at {it}: "
        f"{rep['psnr']!r}; |diff| {diff:.3g} dB; events after the report at {it}, so in the "
        f"checkpoint and not in the report: {events or 'none'} (without events the limit is "
        f"1e-3 dB)")
    if not (n <= means["test"]["n_frames"] and (events or diff <= 1e-3)):
        fail("the render CLI's test PSNR disagrees with the trainer's on the same frames")
    return launched


def lpips_card_check(dev, img, gt, card: str) -> dict:
    """13.2: LPIPS of one rendered frame on the card and on the CPU, with
    the seeded random weights (EX4DGS_LPIPS_WEIGHTS set by the caller).
    Returns each net's relative difference."""
    from ex4dgs_tpu_torch.eval.lpips import LPIPS

    errs = {}
    for net in ("alex", "vgg"):
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail("TF32 is on while LPIPS runs")
        g_ev, c_ev = LPIPS(net, device=dev), LPIPS(net, device="cpu")
        g_ev(img, gt)  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = g_ev(img, gt)
        g_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        c = c_ev(img.cpu(), gt.cpu())
        c_ms = (time.perf_counter() - t0) * 1e3
        if torch.backends.cudnn.allow_tf32:
            fail("TF32 turned on while LPIPS ran")
        errs[net] = abs(g - c) / abs(c)
        log(f"# LPIPS {net} on one {tuple(img.shape)} frame (seeded random weights, not "
            f"LPIPS): card {g!r} in {g_ms:.1f} ms, CPU {c!r} in {c_ms:.0f} ms; |diff| "
            f"{abs(g - c):.3g} (rtol {LPIPS_RTOL:g}, atol {LPIPS_ATOL:g}); cudnn.allow_tf32 "
            f"{torch.backends.cudnn.allow_tf32}; {card}")
        if not abs(g - c) <= LPIPS_ATOL + LPIPS_RTOL * abs(c):
            fail(f"LPIPS {net} on the card disagrees with the CPU")
    return errs


def wire_message(view, proj, width, height, fovx, fovy, t, train=False) -> bytes:
    """A SIBR viewer request for the mathematical matrices view and proj
    (the inverse of viewer.py's receive), length-prefixed."""
    view_t = np.asarray(view, np.float32).T.copy()
    view_t[:, 1] *= -1
    view_t[:, 2] *= -1
    proj_t = np.asarray(proj, np.float32).T.copy()
    proj_t[:, 1] *= -1
    payload = json.dumps({
        "resolution_x": width, "resolution_y": height, "train": train, "fov_x": fovx,
        "fov_y": fovy, "z_near": 0.01, "z_far": 100.0, "shs_python": False,
        "rot_scale_python": False, "keep_alive": False, "scaling_modifier": 1.0,
        "view_matrix": view_t.flatten().tolist(),
        "view_projection_matrix": proj_t.flatten().tolist(), "timestamp": t}).encode()
    return len(payload).to_bytes(4, "little") + payload


def recv_exact(s, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("viewer closed")
        buf += chunk
    return buf


def serve(viewer, render_fn, messages, n_bytes, source_path: str) -> list:
    """A client thread sends `messages` and reads a reply of n_bytes[i]
    image bytes and the verify string for each, timing each round trip,
    then closes; the caller's thread polls the viewer meanwhile. Returns
    [(image bytes, verify, ms)]."""
    import socket
    import threading

    port = viewer.init()
    replies, errors = [], []

    def client():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
                for msg, n in zip(messages, n_bytes):
                    t0 = time.perf_counter()
                    s.sendall(msg)
                    img = recv_exact(s, n) if n else None
                    verify = recv_exact(s, int.from_bytes(recv_exact(s, 4), "little"))
                    replies.append((img, verify, (time.perf_counter() - t0) * 1e3))
        except OSError as e:
            errors.append(e)

    th = threading.Thread(target=client)
    th.start()
    deadline = time.monotonic() + 120
    while th.is_alive() and time.monotonic() < deadline:
        viewer.poll(render_fn, source_path, training_active=True)
        time.sleep(0.001)
    th.join(timeout=30)
    viewer.close()
    if th.is_alive() or errors or len(replies) != len(messages):
        fail(f"viewer: {len(replies)} of {len(messages)} replies, errors {errors}")
    return replies


def viewer_check(dev, model, cfg, scene, capacity: int, card: str) -> tuple[int, int]:
    """13.3: viewer requests for one test camera at full width, served from
    the loaded model, each reply the converted render of its camera bit for
    bit; then the tiny scene's Trainer serving a request on the card, and
    `render_set` on its model giving its test report's PSNR (no event
    runs, so the model is the one the report rendered). Returns kernels A
    and B's launches in these paths."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
    from ex4dgs_tpu_torch.data.readers import read_n3v_scene
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.eval.render_sets import render_set
    from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
    from ex4dgs_tpu_torch.rendering import render
    from ex4dgs_tpu_torch.train.trainer import Trainer
    from ex4dgs_tpu_torch.viewer import NetworkViewer

    cam = scene.sampled_test_cameras()[0]
    rc = cam.render_camera(dev)
    view, proj = rc.view.cpu().numpy(), rc.proj.cpu().numpy()
    bg = torch.zeros(3, device=dev)
    served = []

    def render_fn(req):
        served.append(req)
        return render(req.camera, model, cfg, t=req.timestamp, bg=bg, capacity=capacity,
                      scaling_modifier=req.scaling_modifier, track_idx=False,
                      device=dev).render

    frame_bytes = cam.width * cam.height * 3
    messages = [wire_message(view, proj, cam.width, cam.height, cam.fovx, cam.fovy, t)
                for t in VIEWER_TIMESTAMPS]
    messages.append(wire_message(view, proj, 0, 0, cam.fovx, cam.fovy, 0.0))  # keep-alive
    with torch.no_grad():
        render(rc, model, cfg, t=0.0, bg=bg, capacity=capacity, track_idx=False,
               device=dev)  # warm-up, before the counters are set to 0
        torch.cuda.synchronize()
        kernels.reset_launches()
        replies = serve(NetworkViewer(port=0, device=dev), render_fn, messages,
                        [frame_bytes] * len(VIEWER_TIMESTAMPS) + [0], cfg.source_path)
        torch.cuda.synchronize()
        launched = dict(kernels.launches)
        same = [img == NetworkViewer.to_bytes(render(
            req.camera, model, cfg, t=req.timestamp, bg=bg, capacity=capacity,
            track_idx=False, device=dev).render)
            for req, (img, _, _) in zip(served, replies)]
    cam_err = max(float((served[0].camera.view - rc.view).abs().max()),
                  float((served[0].camera.campos - rc.campos).abs().max()))
    log(f"# viewer: {len(VIEWER_TIMESTAMPS)} requests for {cam.image_name} at {cam.width}x"
        f"{cam.height}, t = {VIEWER_TIMESTAMPS}, and a keep-alive; round trip ms "
        + ", ".join(f"{ms:.2f}" for _, _, ms in replies[:-1])
        + f" (keep-alive {replies[-1][2]:.2f}); replies bit-equal to the converted render "
        f"{same}; launches {launched}; the request's camera against the scene's: "
        f"{cam_err:.3g}; {card}")
    n = len(VIEWER_TIMESTAMPS)
    if not (all(same) and len(served) == n and replies[-1][0] is None
            and all(v == cfg.source_path.encode() for _, v, _ in replies)
            and launched == {**dict.fromkeys(launched, 0), "composite_fwd": n}
            and cam_err <= 1e-5):
        fail("viewer: a reply differs from the render, or the launches are not one per "
             "non-empty request")

    # the Trainer serving the viewer on the card (tests/test_torch_viewer.py's case)
    with tempfile.TemporaryDirectory(prefix="ex4dgs_gui_") as root:
        write_n3v_scene(root, n_cams=3, n_frames=2, n_points=120, width=640, height=480, seed=2)
        cfg_s = ModelConfig(source_path=root, loader="neural3dvideo", resolution=8, duration=-1,
                            time_interval=2, time_pad=1, start_duration=2, near=0.05, far=50.0)
        opt = OptimizationConfig(iterations=3, densify_from_iter=1000, extract_from_iter=1000,
                                 densify_until_iter=0, prune_invisible_interval=100000,
                                 random_background=False)
        gui = NetworkViewer(port=0, device=dev)
        tr = Trainer(cfg_s, opt, Scene(cfg_s, scene_info=read_n3v_scene(root, cfg_s)),
                     capacity=65536, test_iterations=(3,), gui=gui, device=dev)
        port = gui.init()
        result = {}

        def client():
            import socket

            with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
                s.sendall(wire_message(view, proj, 32, 24, cam.fovx, cam.fovy, 1.0, train=True))
                result["img"] = recv_exact(s, 32 * 24 * 3)
                result["verify"] = recv_exact(s, int.from_bytes(recv_exact(s, 4), "little"))

        import threading

        th = threading.Thread(target=client)
        kernels.reset_launches()
        th.start()
        metrics = tr.train(iterations=3)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        th.join(timeout=30)
        (_, report), = metrics["test_reports"]
        timings = {}
        kernels.reset_launches()
        evaluated = render_set(tr.model, cfg_s, tr.scene, "test", measure_fps=False,
                               lpips_nets=(), timings=timings, device=dev)
        torch.cuda.synchronize()
        eval_counts = dict(kernels.launches)
        tr.close()
        gui.close()
    want = tr.steps + tr.gui_renders + tr.test_renders
    log(f"# viewer served by the tiny scene's Trainer on the card: {tr.gui_renders} request in "
        f"{tr.steps} steps, launches {counts} (A = steps + requests + {tr.test_renders} test "
        f"renders = {want}), reply {len(result.get('img', b''))} bytes; render_set on its model "
        f"PSNR {evaluated.get('psnr')!r} over {evaluated['n_frames']} frames, the test report "
        f"{report['psnr']!r} over {report['n_frames']} (<= 1e-3 dB), launches {eval_counts}")
    if not (not th.is_alive() and tr.gui_renders == 1 and result.get("verify") == root.encode()
            and counts == {**dict.fromkeys(counts, 0), "composite_fwd": want,
                           "composite_bwd": 3}):
        fail("the Trainer did not serve the viewer once during its 3 iterations")
    implied = evaluated["n_frames"] + timings["overflow_retries"]
    if not (evaluated["n_frames"] == report["n_frames"] > 0
            and abs(evaluated["psnr"] - report["psnr"]) <= 1e-3
            and eval_counts == {**dict.fromkeys(eval_counts, 0), "composite_fwd": implied}):
        fail("render_set disagrees with the trainer's test report on the same model")
    return (n + counts["composite_fwd"] + eval_counts["composite_fwd"],
            counts["composite_bwd"])


def surface_check(dev, card: str) -> int:
    """13.4: the quality probe's surface scene and rig
    (tools/tpu_probes/_tpu_quality2.py:52-57) rendered on the card at
    t = 0 and 4 from every camera; one camera against the CPU's plain
    render. Returns kernel A's launches."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.models.config import ModelConfig
    from ex4dgs_tpu_torch.models.state import model_from_numpy, model_to_numpy
    from ex4dgs_tpu_torch.rendering import RenderCamera, render
    from ex4dgs_tpu_torch.synthetic import make_surface_scene, rig_cameras

    cfg = ModelConfig(time_interval=2, time_pad=1, start_duration=2, duration=8, near=0.2,
                      far=50.0, resolution=1)
    t0 = time.perf_counter()
    model, _ = make_surface_scene(n_static=50_000, n_dynamic=5_000, duration=8.0, seed=7,
                                  static_capacity=65_536, dynamic_capacity=8_192, cfg=cfg,
                                  device=dev)
    cams = rig_cameras(SURFACE_CAMS, 3.0, SURFACE_W, SURFACE_H, far=cfg.far, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    capacity = 1024 * 1024  # the probe's

    def frame(c, t, d=dev, m=model):
        return render(c, m, cfg, t=t, bg=torch.zeros(3, device=d), capacity=capacity,
                      device=d)

    with torch.no_grad():
        frame(cams[0], 0.0)  # warm-up, before the counters are set to 0
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        stats = []
        for c in cams:
            i0, i4 = frame(c, 0.0), frame(c, 4.0)
            stats.append((bool(torch.isfinite(i0.render).all() and torch.isfinite(i4.render).all()),
                          float(i0.render.mean()), float(i4.render.mean()),
                          float((i0.render - i4.render).abs().max()),
                          max(int(i0.binning_total), int(i4.binning_total))))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (2 * len(cams))
        launched = dict(kernels.launches)
        g = frame(cams[0], 4.0).render.cpu()
        cpu_model = model_from_numpy(**model_to_numpy(model), device="cpu")
        c0 = cams[0]
        cpu_cam = RenderCamera(view=c0.view.cpu(), proj=c0.proj.cpu(), campos=c0.campos.cpu(),
                               width=c0.width, height=c0.height, tan_fovx=c0.tan_fovx.cpu(),
                               tan_fovy=c0.tan_fovy.cpu())
        t1 = time.perf_counter()
        c = frame(cpu_cam, 4.0, "cpu", cpu_model).render
        cpu_s = time.perf_counter() - t1
    err = float((g - c).abs().max())
    moved = sum(s[3] > 0.1 for s in stats)
    log(f"# surface scene (50000 static + 5000 dynamic, seed 7, {SURFACE_CAMS} rig cameras at "
        f"{SURFACE_W}x{SURFACE_H}, built in {build_s:.1f} s): {2 * len(cams)} renders at t = 0 "
        f"and 4, {ms:.2f} ms each (host clock, no sync per frame); mean image "
        f"{min(s[1] for s in stats):.3f}-{max(s[1] for s in stats):.3f} (> 0.05), max |t4 - t0| "
        f"{max(s[3] for s in stats):.3f} (> 0.1 on {moved} of {len(cams)} cameras), most "
        f"instances {max(s[4] for s in stats)} (capacity {capacity}); launches {launched}; "
        f"camera 0 at t = 4 against the CPU plain render ({cpu_s:.1f} s): {err:.3g} "
        f"(atol {IMAGE_TOL:g}); {card}")
    if not (all(s[0] and s[1] > 0.05 and s[2] > 0.05 and s[4] <= capacity for s in stats)
            and moved > 0 and err <= IMAGE_TOL
            and launched == {**dict.fromkeys(launched, 0), "composite_fwd": 2 * len(cams)}):
        fail("surface scene: a render is not finite or not visible, the dynamics did not move "
             "the image, the card disagrees with the CPU, or the launches are not one per "
             "render")
    return launched["composite_fwd"]


def eval_phase(dev, model_dir: str, trained: dict, fps_phase4: dict, card: str) -> dict:
    """Phase 13: the render CLI, LPIPS on the card against the CPU, the
    viewer, and the surface scene. Returns kernels A and B's launches on
    these paths."""
    from ex4dgs_tpu_torch.data.scene import load_image
    from ex4dgs_tpu_torch.rendering import render

    model, cfg, scene = load_trained(dev, model_dir, EVAL_ITERATION)
    with tempfile.TemporaryDirectory(prefix="ex4dgs_lpips_") as wdir:
        for i, net in enumerate(("alex", "vgg")):
            np.savez(os.path.join(wdir, f"lpips_{net}.npz"), **lpips_random_weights(net, 100 + i))
        eval_launches = eval_cli_check(model_dir, trained, scene, fps_phase4, wdir, card)
        cam = scene.sampled_test_cameras()[0]
        with torch.no_grad():
            img = render(cam.render_camera(dev), model, cfg, t=cam.timestamp,
                         bg=torch.zeros(3, device=dev), capacity=trained["capacity"],
                         device=dev).render.clamp(0, 1)
        gt = torch.from_numpy(load_image(cam.image_path, (cam.width, cam.height),
                                         cam.im_scale)).to(dev)
        os.environ["EX4DGS_LPIPS_WEIGHTS"] = wdir
        try:
            lpips_errs = lpips_card_check(dev, img, gt, card)
        finally:
            del os.environ["EX4DGS_LPIPS_WEIGHTS"]
    viewer_a, viewer_b = viewer_check(dev, model, cfg, scene, trained["capacity"], card)
    del model
    torch.cuda.empty_cache()
    surface_a = surface_check(dev, card)
    return {"composite_fwd": {"eval_launches": eval_launches, "viewer_launches": viewer_a,
                              "surface_launches": surface_a,
                              "lpips_rel_err": lpips_errs},
            "composite_bwd": {"viewer_launches": viewer_b}}


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    import ex4dgs_tpu_torch  # noqa: F401  (sets the precision policy)
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import (PROBE_CAPACITY, H, W, bench_scene, cotangents,
                                              cuda_ms, pack_frame)
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.ops.rasterize_cuda import (BWD_ATOL, BWD_RTOL,
                                                     composite_tiles_bwd_plain,
                                                     composite_tiles_bwd_walk,
                                                     composite_tiles_plain)
    from ex4dgs_tpu_torch.rendering import render
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
    from ex4dgs_tpu_torch.train.step import StepStatics, train_step

    dev = torch.device("cuda")
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase_s, clock = [], [time.perf_counter()]

    def phase_done(n: int) -> None:
        now = time.perf_counter()
        phase_s.append((n, now - clock[0]))
        clock[0] = now

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_all()
    log(f"# build: {len(kernels.SOURCES)} sources, {len(kernels.launches)} kernel entry points "
        f"in {time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
    for name, text in kernels.build_logs.items():
        for line in text.strip().splitlines():
            log(f"#   {name}: {line.strip()}")

    phase_done(1)
    # -- 2. scene --------------------------------------------------------
    t0 = time.perf_counter()
    scene = bench_scene(dev)
    model, cfg, cam, total, capacity = scene
    if total > PROBE_CAPACITY:
        fail(f"bench scene overflows the {PROBE_CAPACITY} probe capacity ({total})")
    bg = torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    log(f"# scene: {model.static_capacity} + {model.dynamic_capacity} splats, {W}x{H}, "
        f"{total} instances at t=1 (capacity {capacity}), built in "
        f"{time.perf_counter() - t0:.2f} s")

    phase_done(2)
    # -- 3. forward kernel vs plain ------------------------------------
    tx, ty = 32, 16
    data, gid, starts, stops, gx, n_points = pack_frame(scene, tx, ty)
    args = (data, gid, starts, stops)
    kw = dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True)
    acc_k, tf_k, idx_k = got = kernels.composite_fwd(*args, **kw)
    again = kernels.composite_fwd(*args, **kw)
    want = composite_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    note, ok, err_fwd = fwd_agreement(got, again, want, cfg.far)
    log(f"# composite_fwd vs plain: {note}")
    if not ok:
        fail("composite_fwd disagrees with its plain version")
    if not bool((idx_k >= -1).all()) or int(idx_k.max().item()) >= n_points:
        fail("composite_fwd wrote an id outside [-1, P)")
    del got, again, want

    ms = cuda_ms(lambda: kernels.composite_fwd(*args, **kw), reps=20)
    ms_noidx = cuda_ms(lambda: kernels.composite_fwd(*args, **{**kw, "track_idx": False}),
                       reps=20)
    plain_ms = cuda_ms(lambda: composite_tiles_plain(*args, **kw), reps=2, warmup=1)
    pairs = walked_pairs(data, starts, stops, gx, tx, ty)
    evaluated, contributing, applied = (pairs[k] for k in ("evaluated", "contributing",
                                                           "applied"))
    n_inst = int(stops[-1].item() - starts[0].item())
    T, npix = starts.shape[0], tx * ty
    nbytes = 14 * 4 * n_inst + 4 * n_inst + 2 * 4 * T + T * npix * (8 + 1 + 1) * 4
    bound_ms, bound_by, (t_bytes, t_fp32, t_sfu) = bound_of(
        nbytes, SLOTS_EVAL * contributing + SLOTS_APPLIED * applied, contributing)
    old_bound, _, _ = bound_of(nbytes, SLOTS_EVAL * evaluated + SLOTS_APPLIED * applied,
                               evaluated)
    log(f"# composite_fwd: {ms:.4f} ms/frame (track_idx=False {ms_noidx:.4f}), plain "
        f"{plain_ms:.2f} ms; {n_inst} instances in {T} tiles; lane-pairs evaluated "
        f"{evaluated}, contributing {contributing}, applied {applied}, walked by warps "
        f"{pairs['warp_walked']} without the cull and {pairs['warp_walked_culled']} with "
        f"the cull's twin ({pairs['dropped']} contributing pairs dropped), "
        f"{pairs['slowest_warp']} with each batch at its slowest warp's pace; bound "
        f"{bound_ms:.4f} ms from contributing pairs (bytes {t_bytes:.4f}, fp32 {t_fp32:.4f}, "
        f"sfu exp {t_sfu:.4f}), old bound from evaluated pairs {old_bound:.4f} ms; {card}")
    if pairs["dropped"]:
        fail(f"the cull's twin skips {pairs['dropped']} contributing pairs")
    if ms < bound_ms:
        fail(f"composite_fwd read {ms:.4f} ms, below its bound {bound_ms:.4f} ms")

    phase_done(3)
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

    phase_done(4)
    # -- 5. backward kernel vs plain -------------------------------------
    gacc, acdot, gend = cotangents(acc_k)
    bargs = (data, starts, stops, gacc, acdot, gend, tf_k)
    bkw = dict(grid_x=gx, tile_x=tx, tile_y=ty)
    d_k = kernels.composite_bwd(*bargs, **bkw)
    d_k2 = kernels.composite_bwd(*bargs, **bkw)
    d_p = composite_tiles_bwd_plain(*bargs, **bkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = composite_tiles_bwd_walk(*bargs, **bkw)
    twin_s = time.perf_counter() - t0
    note, ok, err_bwd = bwd_agreement(d_k, d_k2, d_p, twin, int(starts[0].item()),
                                      int(stops[-1].item()))
    log(f"# composite_bwd vs plain, per element |kernel - plain| <= {BWD_RTOL:g} |plain| + "
        f"{BWD_ATOL:g} max |plain| per row group: {note} (the twin took {twin_s:.1f} s)")
    if not ok:
        fail("composite_bwd disagrees with its plain version or its twin")
    del d_k2, d_p, twin
    ms_b = cuda_ms(lambda: kernels.composite_bwd(*bargs, **bkw), reps=20)
    plain_ms_b = cuda_ms(lambda: composite_tiles_bwd_plain(*bargs, **bkw), reps=2, warmup=1)
    nbytes_b = (14 + 16) * 4 * n_inst + 2 * 4 * T + T * npix * (8 + 3) * 4
    bound_b, bound_by_b, (tb_bytes, tb_fp32, tb_sfu) = bound_of(
        nbytes_b, SLOTS_EVAL_B * contributing + SLOTS_APPLIED_B * applied,
        contributing + applied)
    old_bound_b, _, _ = bound_of(nbytes_b, SLOTS_EVAL_B * evaluated + SLOTS_APPLIED_B * applied,
                                 evaluated + applied)
    log(f"# composite_bwd: {ms_b:.4f} ms/frame, plain {plain_ms_b:.2f} ms; lane-pairs "
        f"evaluated {evaluated}, contributing {contributing}, applied {applied}; bound "
        f"{bound_b:.4f} ms from contributing pairs (bytes {tb_bytes:.4f}, fp32 {tb_fp32:.4f}, "
        f"sfu {tb_sfu:.4f}), old bound from evaluated pairs {old_bound_b:.4f} ms; {card}")
    steps = {k: pairs[k] // 32 for k in ("warp_walked", "warp_walked_culled")}
    reduced = pairs["steps_applied"]
    log(f"# composite_bwd walk (twin counts): warp steps {steps['warp_walked']} without the "
        f"cull, {steps['warp_walked_culled']} with it; {reduced} with an applied lane "
        f"({100 * reduced / max(steps['warp_walked_culled'], 1):.1f}% of the culled walk), "
        f"of which {pairs['steps_applied_1']} with 1 applied lane, "
        f"{pairs['steps_applied_2_8']} with 2-8 and {pairs['steps_applied_9_32']} with "
        f"9-32; warp shuffle instructions {reduced * SHUFFLES_BUTTERFLY} with a butterfly "
        f"per value, {reduced * SHUFFLES_TRANSPOSED} with the transposed reduction")
    if ms_b < bound_b:
        fail(f"composite_bwd read {ms_b:.4f} ms, below its bound {bound_b:.4f} ms")
    del bargs, gacc, gend, acdot, d_k, acc_k, tf_k, idx_k, data, gid

    phase_done(5)
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
        if counts != {**dict.fromkeys(counts, 0), "composite_fwd": 1, "composite_bwd": 1}:
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

    phase_done(6)
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

    phase_done(7)
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

    phase_done(8)
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

    phase_done(9)
    probe_entries = probe_phase(dev, starts, stops, card)
    phase_done(10)
    sub = subpixel_phase(dev, scene, bg, pairs, card)
    phase_done(11)
    del scene, model, state, m, st, out
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ex4dgs_phase12_") as tmp:
        trainer, model_dir, trained = trainer_phase(dev, card, tmp)
        phase_done(12)
        evaluation = eval_phase(dev, model_dir, trained, fps, card)
        phase_done(13)
    log("# phase times (s): " + ", ".join(f"{n} {t:.1f}" for n, t in phase_s)
        + f"; total {sum(t for _, t in phase_s):.1f}")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "ex4dgs_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "ex4dgs_tpu/ops/rasterize_pallas.py:439",
        "launches": (render_launches["composite_fwd"] + train_launches["composite_fwd"]
                     + sub["composite_fwd"]["subpixel_launches"]
                     + trainer["composite_fwd"]["trainer_launches"]
                     + evaluation["composite_fwd"]["eval_launches"]
                     + evaluation["composite_fwd"]["viewer_launches"]
                     + evaluation["composite_fwd"]["surface_launches"]),
        **trainer["composite_fwd"],
        **evaluation["composite_fwd"],
        "max_abs_err": err_fwd,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        **sub["composite_fwd"],
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "ex4dgs_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "ex4dgs_tpu/ops/rasterize_pallas.py:713",
        "launches": (train_launches["composite_bwd"] + sub["composite_bwd"]["subpixel_launches"]
                     + trainer["composite_bwd"]["trainer_launches"]
                     + evaluation["composite_bwd"]["viewer_launches"]),
        **trainer["composite_bwd"],
        **evaluation["composite_bwd"],
        "max_abs_err": err_bwd,
        "ms": ms_b,
        "plain_ms": plain_ms_b,
        "bound_ms": bound_b,
        "bound_by": bound_by_b,
        "library_ms": None,
        **sub["composite_bwd"],
    }, *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
