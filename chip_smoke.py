"""Drive the PyTorch/CUDA port's render, training, eval, viewer and quality
paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --only 12   # phases 8 and 12 (step, host reads, trainer)
    python3 chip_smoke.py --only 16   # phase 16 and the inputs it needs
    python3 chip_smoke.py --only 17   # phase 17 (the bench entry point) alone
    python3 chip_smoke.py --only 18   # phase 18 (the slicing kernel pair) alone
    python3 chip_smoke.py --only 19   # phase 19 (the pack VJP kernel) alone

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
   train step of bench.py), 31 steps carrying copies of the model and
   optimizer state (train_step updates them in place; its CUDA graph is
   captured on the second step and replayed after). Every step must launch
   each kernel exactly once (counters reset before each step; a replay
   counts the launches its capture recorded), give a finite loss and finite
   params, not overflow and leave nan_flag false; the loss after the last
   step (t = 0) must be below the first's (t = 0).
7. determinism: two train_steps from copies of one state give bit-equal
   params, moments and stats.
8. timing: train ms/iteration by bench.py's recipe through the bench's own
   functions (`ex4dgs_tpu_torch.bench.measure` of `train_step_tick`: 20
   iterations carrying a copy of the bench state, best of 3 windows, each
   ending in torch.cuda.synchronize), and a torch.profiler breakdown of one
   step. Then the step path's host reads: train_step's eager call, capture
   and replay, one sharded step at
   mesh (1, 1) and one render at t = 2.5 on the bench state, and one
   trainer iteration's dispatch on a tiny on-disk scene, each under
   torch.cuda.set_sync_debug_mode("error") after a warm-up call; none may
   wait for the card (its finalize reads by design).
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
   beside the spread of its turns. (P2b against its earlier builds:
   `python -m ex4dgs_tpu_torch.kernel_turns --other NAME=path.cu`.)
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
   user runs it (pipelined, the default), in a process of its own, with
   only the schedule shortened
   (TRAIN_SCHEDULE) so that 150 iterations cross every event kind that the
   schedule reaches before iteration 3000 (densify_and_prune,
   adjust_temp_opa, expand_duration, static->dynamic extraction), with a
   save and the test-set PSNR at 150; then it resumes from chkpnt150.npz
   for 10 more iterations. The CLI sets the launch counters to 0 before
   training and reports them with everything else in its
   train_report.json. Every loss must be finite and the last 10 must
   average below the first 10; every scheduled event kind must have run;
   kernel A must have launched once per train_step (iterations plus
   overflow retries) and per test render, kernel B once per train_step
   (the overflow gate is on the device: an overflowing attempt runs its
   backward too), nothing else; the PLY and the checkpoint must exist and
   push(load_checkpoint(...)) on the card must pull back bit-equal to the
   trainer's pull at save (sha256 of every array). Printed: ms/iteration by
   the host clock (whole loop, and without the event iterations), each
   event's time, pull and push times, n_static/n_dynamic after each event,
   the GT cache's decoder (the native libpng pool, or PIL where it does not
   build), hits and bytes; the events the schedule does not reach
   before iteration 3000 (prune_invisible, prune_small) or at all
   (prune_nan, reset_opacity) are timed on the saved model. The loop
   pipelined against serial (EX4DGS_PIPELINE=0) at full width in this
   process, on the CLI run's config and scene at its final capacity, over
   the iterations before its first event, in turns (pipelined, serial,
   serial, pipelined): losses and final models bit-equal, no overflow,
   both ms/iteration printed. Last, the trainer on a tiny scene on the
   card and on the CPU for the 20 iterations before its first event
   (losses within rtol 1e-5, the same cameras and backgrounds), and a
   forced overflow on the card and on the CPU (capacity 256: one more
   launch of kernels A and B per retry, the same first loss, and the
   pipelined loop's swap, each overflowed step re-run after the step
   dispatched behind it, in the same order on both).
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
   one camera equal to the CPU's plain render within 3e-5. (The tiny
   scene's trainer decodes with PIL there, as render_set does: its default
   native pool box-filters the resampled frames.)
14. quality run: `python -m ex4dgs_tpu_torch.quality`'s `run` at its
   defaults, the port of tools/tpu_probes/_tpu_quality2.py: the surface
   scene (50k + 5k splats, seed 7) from the 19-camera rig at 800x600, its
   152 ground-truth frames rendered here, the full schedule, 3000
   iterations, camera 0 held out. Printed beside the JAX package's anchors
   (BASELINE.md, strict dots: 33.53 dB, SSIM 0.978, the per-timestamp
   PSNRs, 31.2 dB at 250 and 33.85 at 2500, 52.6k static and 5.9k dynamic):
   the SUMMARY, the PSNR per timestamp, the trajectory, the final cloud,
   the wall time, the host-clock ms per iteration with and without the
   event iterations, and the render FPS at the snug capacity. It fails on
   a held-out PSNR below 32.53 dB (33.53 less BASELINE.md's +-1 dB
   trajectory noise), an SSIM below 0.968, a non-finite loss, or kernel
   launches other than the run implies (A: ground truth, steps with their
   overflow retries, test renders, 8 held-out renders, 1 probe and 550 FPS
   renders; B: one per train_step, overflow retries included). Kernels A
   and B are then held against their plain versions on one training view
   of the trained model, as phase 12 holds them.
15. tight cull: the bench frame with KernelConfig.tight_cull off and on,
   the launch counters set to 0 before and read after: render image,
   depth, acc, flow and dominant index bit-equal (track_idx on, without and
   with the bench offsets), the gradients of an L1 loss through a render
   and one train_step's parameters and moments bit-equal, every culled
   pair's largest alpha over its tile's pixels (and over them moved by the
   bench offsets) below 1/255 by the plain version's arithmetic. Printed:
   the pairs in the tile ranges off and on, kernels A and B in turns on the
   two packed frames, and the bin and pack device ms.
16. multi-GPU (on the one card): (1) the bench frame at t = 1 with its tile
   rows in 2 and 4 slabs, run in turn in this process through
   rendering.composite_projected_slabs at a capacity sized from the worst
   slab (slabs x its total + 25%, bucketed): render, depth, flow, acc and
   dominant index bit-equal to the unsharded frame, one launch of kernel A
   per slab with the counters set to 0 before and read after; every slab
   after the first (tile0 != 0) through kernel A against its plain version
   as phase 3 holds it, and kernel B bit-equal to its twin and within
   BWD_RTOL/BWD_ATOL of plain on seeded cotangents as phase 5 holds it;
   both kernels on the whole frame's tiles from grid_x + 1 (a tile0 that
   does not start a row) against the plain version and bit-equal to the
   whole frame's launch; each slab's A and B CUDA-event times beside the
   whole frame's. (2) torch.distributed on NCCL with one rank: the sharded
   step at mesh (1, 1) from the bench state bit-equal (digest) to
   train_step's, two steps from one state bit-equal, one launch of A and B
   a step, timed by bench.py's recipe beside phase 8. (3) Two spawned ranks
   on the card over gloo (NCCL refuses two ranks on one device), meshes
   (1, 2) and (2, 1) on the bench state: each within tests/test_parallel.py's
   tolerances of train_step (loss rtol 1e-4; per parameter 95% within rtol
   2e-4 / atol 5e-5 and max |diff| < 2e-3; denom x data), the ranks'
   models digest-equal, no overflow, one launch of A and of B per rank a
   step; ms per step. (4) The training CLI as two ranks
   (--mesh_data 2 --coordinator --num_processes --process_id
   --dist_backend gloo) on phase 12's scene for 40 iterations of its
   schedule (densify_and_prune at 30): the ranks' final checkpoints
   digest-equal, finite falling losses, kernel launches as the schedule
   implies, ms/iteration. Every spawned rank has a time limit and is
   killed on failure.

17. the bench entry point: `python -m ex4dgs_tpu_torch.bench` in a
   subprocess at its default sizes (bench.py's scene and recipe), then
   again with EX4DGS_TILE=16x16 EX4DGS_EXACT_SORT=1 and 2 iterations in one
   window, each under a time limit. Its last line must hold bench.py's keys
   in order, finite positive rates and times, instances within the
   capacity, one launch of kernels A and B per fwd+bwd call and per train
   step and one of A (none of B) per render, the kernel config asked for
   (32x16 with the packed key, then 16x16 with the exact sort, whose
   instances must outnumber the first run's) and a `card` naming the card.
   Both lines are printed; the runs' launches join the kernels line. Then
   kernels A and B at the second run's shape, in this process: the bench
   frame at t=1 binned at 16x16 with the exact sort into the capacity the
   bench sized (its instances and capacity must be the run's), A against
   its plain version as in phase 3, B bit-equal to its twin and within
   BWD_RTOL/BWD_ATOL of its plain version as in phase 5.
18. the slicing kernel pair of 4D Gaussian Splatting (csrc/slice4d_fwd.cu,
   csrc/slice4d_bwd.cu) at the shape of the n3v_4dgs cell: 500,000 4D
   Gaussians in a capacity of 503,808 rows, SH degree 3 x time degree 2.
   At the cell's degrees and at pairs below degree 3 (SLICE_DEGREES), both
   kernels against their plain versions on the card (ops/slice4d.py: the
   forward within SLICE_RTOL of each output's largest value, at most
   SLICE_LIVE_SLACK rows' 0.05 marginal test flipped; every gradient within
   SLICE_BWD_RTOL of its leaf's largest) and two launches bit-equal. At the
   cell's degrees both are timed with CUDA events beside their plain
   versions and their bound, the bytes of the call's inputs and outputs at
   3.35 TB/s (698 and 1,340 B a row); a time below the bound fails. Then
   train_step_4d on four 1352x1014 views (16x16 tiles, exact sort) three
   times (an eager call; a capture, which replays; a replay), with the
   launch and graph counters set to 0 before: each kernel, and the pack
   VJP, must launch once a view.
19. the pack VJP kernel (csrc/pack_vjp.cu) at the training cells' shapes:
   the binning of one n3v view (the bench scene at 1352x1014, 32x16 tiles,
   917,504 slots) and of one n3v_4dgs view (phase 18's model, 16x16 tiles,
   exact sort, 4,063,232 slots), taken from the render path itself, with
   seeded cotangents on the live instances (1% of them -0.0): the kernel
   bit-equal to its plain version (ops/rasterize_cuda.py::pack_vjp_plain)
   and two launches bit-equal; the elements where it differs from the float64 prefix
   difference it replaced, in ulps; CUDA-event times beside the bytes
   bound of gsbench/metrics/pack_vjp_roofline.py's count (68 B a live
   instance, 72 B a visible Gaussian, at 3.35 TB/s; a time below it fails),
   beside the plain version and the replaced scan (its library_ms), and the
   two kernels' device times under torch.profiler. A view over
   PACK_VJP_MS_LIMIT fails. Its kernels line entry counts as `launches`
   the main-path calls of phases 6, 12, 14, 15 and 18 (one per train_step
   attempt and view), and this phase's own calls as `microbench_launches`.

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
    """The card's name and power limit as nvidia-smi prints them."""
    from ex4dgs_tpu_torch.bench import card

    return card()


def report_profile(what: str, fn, card: str, wall_ms: float | None = None) -> None:
    """Log the breakdown of fn by ex4dgs_tpu_torch.runtime.profiling.
    profile_calls (3 calls) and the peak memory since the last reset. Given
    `wall_ms`, fn's ms per call timed without the profiler, also the device
    busy share, device ms over wall_ms, as the bench's `device_busy_share`."""
    from ex4dgs_tpu_torch.runtime.profiling import profile_calls

    breakdown = profile_calls(fn)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if breakdown is None:
        log(f"# profile {what}: device time not measured (the profiler saw no device "
            f"activity); peak memory {peak_gib:.2f} GiB")
        return
    wall_p, dev_p, n_events, rows = breakdown
    share = ("" if wall_ms is None else f", device busy share {dev_p / wall_ms:.3f} of the "
             f"{wall_ms:.3f} ms/call timed without the profiler")
    log(f"# profile {what} (torch.profiler, 3 calls): {wall_p:.3f} ms/call wall under the "
        f"profiler, {dev_p:.3f} ms/call on the device in {n_events:.0f} device kernels and "
        f"copies per call{share}, peak memory {peak_gib:.2f} GiB; {card}")
    for name, ms_k, count in rows:
        log(f"#   {ms_k:8.4f} ms  x{count:5.1f}  {name[:100]}")


def sync_check(dev, scene, gt, statics, card: str) -> None:
    """Phase 8's check that the step path makes no host read: train_step's
    eager call, its graph's capture and a replay, one sharded step at mesh
    (1, 1) and one render at t = 2.5 (dynamic points in view) on the bench
    state, and one trainer iteration's dispatch on a tiny on-disk scene,
    each after a warm-up call, under torch.cuda.set_sync_debug_mode("error")
    (runtime.profiling.host_syncs). Fails if any of them waits for the
    card."""
    from ex4dgs_tpu_torch import upload
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
    from ex4dgs_tpu_torch.data.readers import read_n3v_scene
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.parallel import make_mesh
    from ex4dgs_tpu_torch.parallel.step_dp import make_sharded_train_step
    from ex4dgs_tpu_torch.rendering import render
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.runtime.profiling import host_syncs
    from ex4dgs_tpu_torch.train.step import clone_state, train_step
    from ex4dgs_tpu_torch.train.trainer import Trainer

    model, cfg, cam, _, capacity = scene
    state = init_state(model.params, device=dev)
    bg = torch.zeros(3, device=dev)
    sharded = make_sharded_train_step(statics, make_mesh(device=dev), device=dev)
    found = {}
    # train_step's three ways to run, on a copy of the bench state (the step
    # updates it in place): its key's eager first call, the capture of its
    # CUDA graph with the first replay, and a replay; after a warm-up call
    # on another copy, kept alive so that the checked copy lies elsewhere
    # (another key)
    warm = clone_state(model, state)
    train_step(*warm, cam, gt, 2.5, bg, 100, statics, device=dev)
    m, st = clone_state(model, state)
    before = kernels.graph_call_counts(dev)
    for how in ("eager", "capture", "replay"):
        found[f"train_step ({how})"] = host_syncs(
            lambda: train_step(m, st, cam, gt, 2.5, bg, 100, statics, device=dev))
    after = kernels.graph_call_counts(dev)
    ran = {k: after[k] - before[k] for k in after}
    if ran != {"eager": 1, "captures": 1, "replays": 2}:
        fail(f"three train_steps of one key ran {ran}: expected eager, capture, replay")
    calls = {
        "sharded step (1, 1)": lambda: sharded(model, state, cam, gt, 2.5, bg, 100),
        "render t=2.5": lambda: render(cam, model, cfg, t=2.5, bg=bg, capacity=capacity,
                                       device=dev),
    }
    for name, fn in calls.items():
        fn()
        found[name] = host_syncs(fn)
    with tempfile.TemporaryDirectory(prefix="ex4dgs_sync_") as root:
        write_n3v_scene(root, n_cams=4, n_frames=6, n_points=300, width=640, height=480, seed=1)
        tcfg = ModelConfig(source_path=root, loader="neural3dvideo", resolution=8, duration=-1,
                           time_interval=2, time_pad=1, start_duration=2, near=0.05, far=50.0)
        opt = OptimizationConfig(iterations=10, densify_from_iter=1000, extract_from_iter=1000,
                                 progressive_growing_steps=1000, random_background=True)
        tr = Trainer(tcfg, opt, Scene(tcfg, scene_info=read_n3v_scene(root, tcfg)),
                     capacity=65536, seed=11, device=dev)
        tr.train(iterations=3)
        c = tr.scene.sampled_train_cameras()[0]
        g = tr.prefetcher.load(c)
        bg_np = np.random.default_rng(0).uniform(size=3).astype(np.float32)
        found["trainer dispatch"] = host_syncs(
            lambda: tr._dispatch(4, c, c, g, upload(bg_np, dev), [c]))
        tr.close()
    log("# no host read (torch.cuda.set_sync_debug_mode('error'), after one warm-up call "
        "each; train_step's eager call, capture and replay each): " + "; ".join(f"{k} {'none' if not v else v}" for k, v in found.items())
        + f"; {card}")
    if any(found.values()):
        fail("a call on the step path waits for the card: "
             + "; ".join(f"{k}: {v}" for k, v in found.items() if v))


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
    if backward_counts != {**want, "composite_fwd": 1, "composite_bwd": 1, "pack_vjp": 1}:
        fail(f"the subpixel backward launched {backward_counts}, expected one of A, B and the "
             f"pack VJP")
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
    per train_step too (the overflow gate is on the device, so an
    overflowing attempt runs its backward as JAX's does); no other
    kernel."""
    first, last = report["iterations"]
    attempts = last - first + 1 + report["overflow_retries"]
    want = {"composite_fwd": attempts + report["test_renders"] + report["gui_renders"],
            "composite_bwd": attempts, "pack_vjp": attempts}
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
        f"{report['kernel_launches']}; the step's CUDA graph {report['graph_calls']}, replay "
        f"share {report['graph_replay_share']:.3f}; {card}")
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
    log(f"#   GT cache: decoder {gt['decoder']} (frames by decoder {gt['decoded']}; native pool "
        f"missing because: {gt['native_error']}), {gt['hits']} hits, {gt['decodes']} decodes "
        f"(waited on, mean {statistics.mean(gt['wait_ms'] or [0]):.1f} ms each; PIL decodes in "
        f"a worker thread, mean {statistics.mean(gt['decode_ms'] or [0]):.1f} ms; upload mean "
        f"{statistics.mean(gt['upload_ms'] or [0]):.2f} ms), {gt['bytes'] / 2**20:.1f} MiB on the "
        f"device; scene read in {report['scene_s']:.2f} s, trainer built (points, KNN scales, "
        f"the first event) in {report['init_s']:.2f} s; save (PLYs, checkpoint, digest) ms "
        + ", ".join(f"{t:.0f}" for t in report["save_ms"])
        + f"; test reports {report['test_reports']}")


def trainer_kernels_hold(dev, model, cfg, capacity: int, card: str, cam=None,
                         what: str = "trainer path") -> dict:
    """Kernels A and B on the trainer path's own inputs: the saved model
    (static and dynamic rows) seen by one train camera (`cam`, a data
    Camera; default the middle one of the config's scene) at its timestamp,
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

    if cam is None:
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
    log(f"# {what}, saved model through {cam.image_name} at t={cam.timestamp:g} "
        f"({cam.width}x{cam.height}, {n_points} rows, {hi - lo} instances in capacity "
        f"{capacity}, tile {tx}x{ty}, longest tile {longest}): composite_fwd vs plain: "
        f"{note_a}; composite_bwd vs plain: {note_b}; the plain version at chunk=1 against "
        f"itself at chunk=64, worst err/limit: "
        + ", ".join(f"{k} {e[1]:.3g}" for k, e in spread.items()) + f"; {card}")
    if not (ok_a and ok_b):
        fail(f"a kernel disagrees with its plain version on the {what}'s inputs")
    return {"composite_fwd": err_a, "composite_bwd": err_b}


def trainer_phase(dev, card: str, tmp: str) -> tuple[dict, str, dict]:
    """Phase 12: the training entry point at full width through a whole
    (shortened) schedule, the kernels against their plain versions on its
    saved model, a resume, the events the schedule does not reach, and the
    trainer on a tiny scene on the card against the CPU. The scene and the
    model go to `tmp`. Returns kernels A and B's launches in the trainer's
    runs and their largest difference from the plain versions on the saved
    model, the pack VJP's launches there, the model directory, and the first run's train_report.json."""
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
    serial_vs_pipelined(dev, first, out, card)

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
    launched = {name: first["kernel_launches"][name] + resumed["kernel_launches"][name]
                + small[name] for name in ("composite_fwd", "composite_bwd", "pack_vjp")}
    return {name: {"trainer_launches": launched[name], "trainer_max_abs_err": errs[name]}
            for name in ("composite_fwd", "composite_bwd")} | {
        "pack_vjp": {"trainer_launches": launched["pack_vjp"]}}, out, first


def serial_vs_pipelined(dev, first: dict, model_dir: str, card: str) -> None:
    """The loop pipelined (the default) against serial (EX4DGS_PIPELINE=0)
    at full width, in this process: the CLI run's config (its
    cfg_args.json), scene and seed, for the iterations before its first
    event, at the capacity the CLI run ended with (the run overflows at
    its first step from the default capacity, and an overflow reorders the
    pipelined loop's cameras), in turns (pipelined, serial, serial,
    pipelined). Every run's losses and final model must be bit-equal and
    none may overflow. Prints each turn's ms/iteration: the mean over the
    run and the median of its second half (the first epoch decodes its
    frames)."""
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.io.checkpoint import digest
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.models import density as D
    from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig, overlay_json
    from ex4dgs_tpu_torch.train.trainer import Trainer

    args = os.path.join(model_dir, "cfg_args.json")
    cfg, opt = overlay_json(ModelConfig(), args), overlay_json(OptimizationConfig(), args)
    pre = min(first["event_iterations"]) - 1
    turns = []
    before = os.environ.get("EX4DGS_PIPELINE")
    try:
        for name in ("pipelined", "serial", "serial", "pipelined"):
            os.environ["EX4DGS_PIPELINE"] = "1" if name == "pipelined" else "0"
            tr = Trainer(cfg, opt, Scene(cfg), capacity=first["capacity"], seed=0,
                         kernel=KernelConfig.from_env(), device=dev)
            torch.cuda.synchronize()
            m = tr.train(iterations=pre)
            torch.cuda.synchronize()
            turns.append(dict(name=name, loss=m["loss"], pipeline=m["pipeline"],
                              overflow=tr.overflow_count, digest=digest(D.pull(tr.model,
                                                                              tr.opt_state)),
                              mean=statistics.mean(m["iter_ms"]),
                              late=statistics.median(m["iter_ms"][pre // 2:])))
            tr.close()
    finally:
        if before is None:
            os.environ.pop("EX4DGS_PIPELINE", None)
        else:
            os.environ["EX4DGS_PIPELINE"] = before
    same = all(t["loss"] == turns[0]["loss"] and t["digest"] == turns[0]["digest"]
               for t in turns)
    log(f"# trainer loop pipelined against serial at full width, iterations 1-{pre} (before "
        f"the first event), capacity {first['capacity']}, in this process, in turns: "
        + "; ".join(f"{t['name']} (pipeline {t['pipeline']}) {t['mean']:.3f} ms/iteration "
                    f"mean, {t['late']:.3f} median of iterations {pre // 2 + 1}-{pre}, "
                    f"{t['overflow']} overflows" for t in turns)
        + f"; losses and final models bit-equal {same}; {card}")
    if not same or any(t["overflow"] for t in turns) or [t["pipeline"] for t in turns] != [
            True, False, False, True]:
        fail("trainer path: the pipelined loop and the serial one disagree before the "
             "first event")


def small_trainer_check(dev, card: str) -> dict:
    """The trainer on a tiny on-disk scene (the CPU tests' size) on the
    card and on the CPU, for the 20 iterations before its first event:
    losses within rtol 1e-5 (tests/test_torch_train.py's step tolerance,
    phase 9's for the loss of one step on the card against the CPU).
    Then the card's run on through its 120-iteration schedule, where the
    cloud outgrows its static capacity (the growth branch of the capacity
    policy, which the full-width run does not reach), and a forced
    overflow on the card and on the CPU (starting capacity 256): the same
    first loss as the run that never overflowed, one more launch of
    kernels A and B per retry, and the pipelined loop's swap (each
    overflowed step re-run after the step dispatched behind it) in the same
    order of (iteration, timestamp) on both. Returns the card runs'
    launches."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
    from ex4dgs_tpu_torch.data.readers import read_n3v_scene
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
    from ex4dgs_tpu_torch.train import trainer as trainer_mod
    from ex4dgs_tpu_torch.train.trainer import Trainer

    step, order = trainer_mod.train_step, []

    def recording(model, opt_state, cam, gt, t, bg, it, statics, **kw):
        order.append((int(it), float(t)))
        return step(model, opt_state, cam, gt, t, bg, it, statics, **kw)

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
        runs, orders = {}, {}
        for d, cap, iters in (("cuda", 65536, n), ("cpu", 65536, n), ("cuda", 256, 3),
                              ("cpu", 256, 3)):
            tr = Trainer(cfg, opt, Scene(cfg, scene_info=read_n3v_scene(root, cfg)),
                         capacity=cap, seed=11, device=d)
            kernels.reset_launches()
            order.clear()
            trainer_mod.train_step = recording
            try:
                metrics = tr.train(iterations=iters)
            finally:
                trainer_mod.train_step = step
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            orders[(d, cap)] = list(order)
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
                           "composite_bwd": steps, "pack_vjp": steps}):
        fail("the small trainer's static capacity did not grow on the card, or its run "
             "through the schedule was not finite or launched other than A, B and the pack "
             "VJP per step")
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
    if (gc != {**dict.fromkeys(gc, 0), "composite_fwd": n, "composite_bwd": n, "pack_vjp": n}
            or any(cc.values())):
        fail(f"small trainer launches: card {gc}, cpu {cc}")
    o, oc, retries, _ = runs[("cuda", 256)]
    swap = orders[("cuda", 256)]
    firsts = orders[("cuda", 65536)]
    log(f"# forced overflow on the card (capacity 256, pipelined {o['pipeline']}): {retries} "
        f"retries, launches {oc}, first loss {o['loss'][0]!r} against {g['loss'][0]!r} without "
        f"the overflow; train_step calls (iteration, timestamp) {swap} on the card, "
        f"{orders[('cpu', 256)]} on the CPU; {card}")
    # pipelined, the re-run of step 1 follows step 2's dispatch
    want_order = [firsts[i] for i in ((0, 1, 0) if o["pipeline"] else (0, 0, 1))]
    if not (retries >= 1 and oc["composite_fwd"] == 3 + retries
            and oc["composite_bwd"] == 3 + retries and o["loss"][0] == g["loss"][0]
            and o["timestamps"] == g["timestamps"][:3] and swap == orders[("cpu", 256)]
            and swap[:3] == want_order):
        fail("the forced overflow did not grow and re-run each overflowed camera once per "
             "retry, in the same order as on the CPU")
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
    runs, so the model is the one the report rendered; the trainer decodes
    its frames with PIL, as render_set does, not with its default native
    pool, which box-filters the resampled frames). Returns kernels A and
    B's launches in these paths."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
    from ex4dgs_tpu_torch.data.readers import read_n3v_scene
    from ex4dgs_tpu_torch.data.scene import ImagePrefetcher, Scene
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
        tr.prefetcher.close()
        tr.prefetcher = ImagePrefetcher(native=False, device=dev)
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
                           "composite_bwd": tr.steps, "pack_vjp": tr.steps}):
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


# Phase 14: the quality run (tools/tpu_probes/_tpu_quality2.py) at full
# width through python -m ex4dgs_tpu_torch.quality's `run`, and the JAX
# package's anchors on the TPU (BASELINE.md "surface, 19 cams, 3000 iters",
# strict dots): held-out PSNR and SSIM, per timestamp, the trajectory and
# the final cloud. These are quality figures; no TPU time is compared.
JAX_PSNR, JAX_SSIM, PSNR_NOISE = 33.53, 0.978, 1.0
JAX_PSNR_BY_T = (34.4, 35.1, 35.2, 35.1, 34.9, 33.5, 31.2, 28.9)
JAX_TRAJECTORY = {250: 31.2, 2500: 33.85}
JAX_N_STATIC, JAX_N_DYNAMIC = 52_600, 5_900
SSIM_FLOOR = JAX_SSIM - 0.01


def quality_phase(dev, card: str, tmp: str) -> dict:
    """Phase 14: the surface scene at 800x600 from the 19-camera rig, the
    full schedule, 3000 iterations (quality.run with its defaults). Fails
    on a held-out PSNR below JAX's anchor less the trajectory noise, an
    SSIM below JAX's less 0.01, a non-finite loss, or kernel launches other
    than the run implies: kernel A once per ground-truth render (19 x 8),
    per train_step call (iterations and overflow retries), per test render,
    per held-out render (8), for the probe and for each of the 50 + 500 FPS
    renders; kernel B once per train_step call as well (an attempt that
    overflows its capacity runs its backward, gated on the device, and is
    re-run). Then kernels A and B against
    their plain versions on one training view of the trained model
    (trainer_kernels_hold). Returns A's and B's launches and errors, and
    the pack VJP's launches, for the kernels line."""
    from ex4dgs_tpu_torch import kernels, quality

    args = quality.parse_args(["--out", os.path.join(tmp, "quality")])
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = quality.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    s, tr, st = out["summary"], out["trainer"], out["stages"]
    log("# quality run SUMMARY " + json.dumps(s))
    pr = quality.PRESETS[args.preset]
    log(f"# quality run: {args.iters} iterations of the full schedule on {s['n_cams']} "
        f"cameras at {pr['width']}x{pr['height']} (camera 0 held out): held-out PSNR "
        f"{s['psnr']:.4f} dB (JAX {JAX_PSNR}, floor {JAX_PSNR - PSNR_NOISE:.2f}), SSIM {s['ssim']:.5f} (JAX {JAX_SSIM}, "
        f"floor {SSIM_FLOOR:.3f}), skimage SSIM {s['ssim_sk']:.5f}; n_static {s['n_static']} "
        f"(JAX {JAX_N_STATIC}), n_dynamic {s['n_dynamic']} (JAX {JAX_N_DYNAMIC}); {card}")
    log("# quality run, held-out PSNR by timestamp (port / JAX): " + ", ".join(
        f"t={t} {s['psnr_by_t'][str(t)]:.2f} / {j}" for t, j in enumerate(JAX_PSNR_BY_T)))
    log("# quality run, held-out PSNR trajectory (iteration psnr; JAX 31.2 at 250, 33.85 at "
        "2500): " + ", ".join(f"{it} {v:.3f}" for it, v in s["test_psnr"]))
    n_ev = s["event_iterations"]
    stage_s = ", ".join(f"{k} {v['s']:.1f} s" for k, v in st.items())
    log(f"# quality run: wall {wall:.1f} s in all ({stage_s}); training {s['train_wall_s']} s, "
        f"host clock {s['ms_per_iteration']:.3f} ms/iteration, "
        f"{s['ms_per_iteration_without_events']:.3f} without the {n_ev} event iterations; "
        f"{tr.steps} train_step calls ({tr.overflow_count} overflow retries, capacity "
        f"{tr.capacity}), {tr.test_renders} test renders; events {tr.event_counts}; render "
        f"FPS {s['render_fps']} ({s['render_mpix_s']} Mpix/s) at RCAP {s['render_capacity']}; "
        f"decoder {s['decoder']}; {card}")
    log("# quality run, after each event (iteration, kind, n_static, n_dynamic): "
        + "; ".join(f"{it} {kind} {ns} {nd}" for it, kind, ns, nd in tr.event_log))
    if s["psnr"] > JAX_PSNR + PSNR_NOISE:
        log(f"# quality run: held-out PSNR {s['psnr']:.4f} dB is above JAX's anchor plus the "
            f"noise ({JAX_PSNR + PSNR_NOISE:.2f}); not a failure (PERF.md explains it)")
    n_gt = s["n_cams"] * quality.N_T
    want_a = (n_gt + tr.steps + tr.test_renders + quality.N_T + 1
              + quality.FPS_WARMUP + quality.FPS_RENDERS)
    want = {**dict.fromkeys(launched, 0), "composite_fwd": want_a,
            "composite_bwd": tr.steps, "pack_vjp": tr.steps}
    log(f"# quality run launches {launched}, the run implies {want} ({n_gt} ground truth + "
        f"{tr.steps} steps + {tr.test_renders} test + {quality.N_T} held-out + 1 probe + "
        f"{quality.FPS_WARMUP} + {quality.FPS_RENDERS} FPS renders; B once per step, overflow "
        f"retries included); by "
        f"stage " + json.dumps(s["kernel_launches"]))
    if not s["loss_finite"]:
        fail("quality run: a non-finite loss")
    if launched != want or tr.steps - tr.overflow_count != args.iters:
        fail("quality run: the kernel launches are not what the run implies")
    if not (s["psnr"] >= JAX_PSNR - PSNR_NOISE and s["ssim"] >= SSIM_FLOOR):
        fail(f"quality run: held-out PSNR {s['psnr']:.4f} dB or SSIM {s['ssim']:.5f} below "
             f"{JAX_PSNR - PSNR_NOISE:.2f} / {SSIM_FLOOR:.3f}")
    cams = tr.scene.train_cameras
    errs = trainer_kernels_hold(dev, tr.model, out["cfg"], tr.capacity, card,
                                cam=cams[len(cams) // 2], what="quality run")
    return {name: {"quality_launches": launched[name], "quality_max_abs_err": errs[name]}
            for name in ("composite_fwd", "composite_bwd")} | {
        "pack_vjp": {"quality_launches": launched["pack_vjp"]}, "summary": s, "wall_s": wall}


def tight_cull_phase(dev, card: str) -> dict:
    """Phase 15: the tight cull (KernelConfig.tight_cull) on the bench
    frame. With the cull off and on: render image, depth, acc, flow and
    dominant index bit-equal (track_idx on, without and with the bench
    offsets), the gradients of an L1 loss through a render and one
    train_step's parameters and moments bit-equal; every culled pair's
    largest alpha over its tile's pixels (and over them moved by the bench
    offsets), by the plain version's arithmetic, below 1/255. The launch
    counters are set to 0 before these renders and steps and read after
    them. Printed: the pairs in the tile ranges with the cull off and on,
    kernels A and B in turns on the two frames, and the bin and pack
    device ms. Returns A's and B's launches and times, and the pack VJP's
    launches, for the kernels line."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import (bench_offsets, bench_scene, cotangents, cuda_ms,
                                              pack_frame)
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.binning import bin_gaussians
    from ex4dgs_tpu_torch.ops.compositing import ALPHA_MAX, ALPHA_MIN
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.ops.rasterize_cuda import pack_sorted, tile_offsets
    from ex4dgs_tpu_torch.ops.rasterize_tiled import tile_pixels
    from ex4dgs_tpu_torch.rendering import preprocess_points, render
    from ex4dgs_tpu_torch.train.step import StepStatics, clone_state, train_step

    scene = bench_scene(dev)
    model, cfg, cam, _, capacity = scene
    kc = {tight: KernelConfig(tight_cull=tight) for tight in (False, True)}
    bg = torch.zeros(3, device=dev)
    off_img = bench_offsets(dev)
    P = model.static_capacity + model.dynamic_capacity
    gen = torch.Generator(device=dev).manual_seed(5)
    flow_dirs = torch.randn((P, 3), device=dev, generator=gen) * 0.1
    gt = torch.rand((cam.height, cam.width, 3), device=dev, generator=gen)

    kernels.reset_launches()
    same = {}
    with torch.no_grad():
        for name, off in (("no offsets", None), ("bench offsets", off_img)):
            res = {t: render(cam, model, cfg, t=1.0, bg=bg, capacity=capacity,
                             subpixel_offset=off, flow_dirs=flow_dirs, track_idx=True,
                             kernel_cfg=kc[t], device=dev) for t in (False, True)}
            same[name] = {f: torch.equal(getattr(res[False], f), getattr(res[True], f))
                          for f in ("render", "depth", "acc", "opticalflow", "dominent_idxs",
                                    "binning_total")}
    grads = {}
    for tight in (False, True):
        leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
        r = render(cam, model.replace(params=leaves), cfg, t=1.0, bg=bg, capacity=capacity,
                   kernel_cfg=kc[tight], device=dev)
        (r.render - gt).abs().mean().backward()
        grads[tight] = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    same_grad = grads[False].keys() == grads[True].keys() and all(
        torch.equal(grads[False][k], grads[True][k]) for k in grads[False])
    steps = {}
    for tight in (False, True):
        st = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=3.0,
                         capacity=capacity, kernel=kc[tight])
        steps[tight] = train_step(*clone_state(model, init_state(model.params, device=dev)),
                                  cam, gt, 1.0, bg, 100, st, device=dev)
    a, b = steps[False], steps[True]
    same_step = (torch.equal(a.loss, b.loss) and all(
        torch.equal(a.model.params[k], b.model.params[k])
        and torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
        and torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]) for k in a.model.params))
    torch.cuda.synchronize()
    launched = dict(kernels.launches)
    want = {**dict.fromkeys(launched, 0), "composite_fwd": 4 + 2 + 2, "composite_bwd": 2 + 2,
            "pack_vjp": 2 + 2}
    nonzero = sum(int((g != 0).any()) for g in grads[False].values())
    log(f"# tight cull, bench frame at t=1, cull off against on: render, depth, acc, flow, "
        f"dominant ids bit-equal {same}; gradients of an L1 loss through a render bit-equal "
        f"{same_grad} ({nonzero} of {len(grads[False])} params with non-zero gradients); one "
        f"train_step's loss, params and moments bit-equal {same_step}; launches {launched} "
        f"(4 renders, 2 backward renders, 2 steps: {want})")
    if not (all(all(v.values()) for v in same.values()) and same_grad and same_step
            and nonzero > 0):
        fail("tight cull: the render or the gradients differ with the cull on")
    if launched != want:
        fail(f"tight cull: launches {launched}, the path implies {want}")
    del grads, steps, a, b

    # which pairs the cull drops, and how much alpha they could have had
    with torch.no_grad():
        pts = point_data_at_t(model, cfg, 1.0)
        proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far)
        gx, gy = tile_grid(cam.width, cam.height)
        T = gx * gy
        bins = {t: bin_gaussians(proj, gx, gy, capacity, tight_cull=t) for t in (False, True)}
        n = int(bins[False].total)

        def pair_keys(b):
            tid, g = b.tile_id[:n].long(), b.order[:n].long()
            keep = tid < T
            return g[keep] * T + tid[keep]

        k_off, k_on = pair_keys(bins[False]), pair_keys(bins[True])
        in_ranges = {t: int((bins[t].tile_stop - bins[t].tile_start).sum()) for t in bins}
        subset = bool(torch.isin(k_on, k_off).all())
        culled = k_off[~torch.isin(k_off, k_on)]
        g_c, t_c = culled // T, culled % T
        pix = tile_pixels(gx, gy, 32, 16, dev)
        pix_off = pix + tile_offsets(off_img, gx, gy, 32, 16)
        opac = proj.opacity * proj.valid
        amax = {}
        for name, px in (("pixels", pix), ("offset pixels", pix_off)):
            best = torch.zeros((), device=dev)
            for c0 in range(0, culled.numel(), 32768):
                g, tl = g_c[c0:c0 + 32768], t_c[c0:c0 + 32768]
                dx = proj.xy[g, 0][:, None] - px[tl, :, 0]
                dy = proj.xy[g, 1][:, None] - px[tl, :, 1]
                power = (-0.5 * (proj.conic[g, 0][:, None] * dx * dx
                                 + proj.conic[g, 2][:, None] * dy * dy)
                         - proj.conic[g, 1][:, None] * dx * dy)
                alpha = torch.clamp_max(opac[g][:, None] * torch.exp(torch.clamp_max(power, 0.0)),
                                        ALPHA_MAX)
                best = torch.maximum(best, torch.where(power <= 0.0, alpha, 0.0).max())
            amax[name] = best.item()
        flow = torch.zeros_like(colors)
        bin_ms = {t: cuda_ms(lambda t=t: bin_gaussians(proj, gx, gy, capacity, tight_cull=t),
                             reps=20) for t in (False, True)}
        pack_ms = {t: cuda_ms(lambda t=t: pack_sorted(proj, colors, flow, bins[t]), reps=20)
                   for t in (False, True)}
    frames = {t: pack_frame(scene, tight_cull=t) for t in (False, True)}
    fw = {t: ((f.data, f.gid, f.starts, f.stops), dict(grid_x=f.grid_x, tile_x=32, tile_y=16,
                                                     track_idx=True))
          for t, f in frames.items()}
    outs = {t: kernels.composite_fwd(*fw[t][0], **fw[t][1]) for t in fw}
    same_fwd = all(torch.equal(x, y) for x, y in zip(outs[False], outs[True]))
    gacc, acdot, gend = cotangents(outs[False][0])
    bw = {t: ((f.data, f.starts, f.stops, gacc, acdot, gend, outs[t][1]),
              dict(grid_x=f.grid_x, tile_x=32, tile_y=16)) for t, f in frames.items()}
    a_t = in_turns({f"cull {'on' if t else 'off'}": (lambda t=t: kernels.composite_fwd(
        *fw[t][0], **fw[t][1])) for t in (False, True)})
    b_t = in_turns({f"cull {'on' if t else 'off'}": (lambda t=t: kernels.composite_bwd(
        *bw[t][0], **bw[t][1])) for t in (False, True)})
    turns = {"A": a_t, "B": b_t}
    log(f"# tight cull, bench frame at t=1: {in_ranges[False]} instance-tile pairs in the tile "
        f"ranges with the cull off, {in_ranges[True]} on ({culled.numel()} culled, "
        f"{100 * culled.numel() / max(in_ranges[False], 1):.2f}%; total {n} either way; on a "
        f"subset of off {subset}); the culled pairs' largest alpha over their tile's pixels "
        f"{amax['pixels']:.4g}, over the pixels moved by the bench offsets "
        f"{amax['offset pixels']:.4g} (below 1/255 = {ALPHA_MIN:.6f}); kernel A outputs on "
        f"the two packed frames bit-equal {same_fwd}")
    log("# tight cull, kernels in turns (mean, first turn, second turn; ms): "
        + "; ".join(f"{k} {n} {v[0]:.4f} ({v[1]:.4f}, {v[2]:.4f})" for k, d in turns.items()
                    for n, v in d.items())
        + f"; bin_gaussians device ms off {bin_ms[False]:.4f}, on {bin_ms[True]:.4f}; "
        f"pack_sorted off {pack_ms[False]:.4f}, on {pack_ms[True]:.4f}; {card}")
    if not (subset and amax["pixels"] < ALPHA_MIN and amax["offset pixels"] < ALPHA_MIN
            and same_fwd and in_ranges[True] < in_ranges[False]):
        fail("tight cull: a culled pair reaches the alpha floor, the cull added pairs, it "
             "culled nothing, or kernel A differs on the culled frame")
    return {"composite_fwd": {"tight_cull_launches": launched["composite_fwd"],
                              "tight_cull_ms": a_t["cull on"][0],
                              "tight_cull_ms_off": a_t["cull off"][0]},
            "composite_bwd": {"tight_cull_launches": launched["composite_bwd"],
                              "tight_cull_ms": b_t["cull on"][0],
                              "tight_cull_ms_off": b_t["cull off"][0]},
            "pack_vjp": {"tight_cull_launches": launched["pack_vjp"]},
            "pairs": in_ranges, "bin_ms": bin_ms, "pack_ms": pack_ms}


# Phase 16: the slab counts of the in-process slab check, the meshes of the
# two gloo ranks on the one card, and the 2-rank trainer CLI's schedule
# (TRAIN_SCHEDULE's: densify_and_prune at 30).
SLAB_COUNTS = (2, 4)
GLOO_MESHES = ((1, 2), (2, 1))
CLI16_ITERS = 40
RANK_TIMEOUT = 300  # seconds for a spawned job; its ranks are killed past it


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worst_slab_capacity(proj, gx: int, gy: int, slabs: int, floor: int) -> tuple[int, list]:
    """(capacity, per-slab instance totals): the sharded capacity sized from
    the fullest slab (slabs x its total + 25%, bucketed to 65536, as the
    trainer's growth policy rounds), at least `floor`."""
    from ex4dgs_tpu_torch.models.state import round_capacity
    from ex4dgs_tpu_torch.ops.binning import bin_gaussians

    rows = -(-gy // slabs)
    totals = [int(bin_gaussians(proj, gx, gy, 65536, row0=r * rows, rows=rows,
                                total_tiles=gx * gy).total) for r in range(slabs)]
    return max(floor, round_capacity(slabs * max(totals) * 5 // 4, 65536)), totals


def slab_phase(dev, scene, whole_ms: dict, card: str) -> tuple[dict, dict]:
    """16.1: the bench frame's tile rows in 2 and 4 slabs, run in turn in
    this process. Returns (kernel fields, the sharded capacities by slab
    count)."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import cotangents, cuda_ms, pack_frame
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.binning import bin_gaussians
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.ops.rasterize_cuda import (bwd_errors, composite_tiles_bwd_plain,
                                                     composite_tiles_bwd_walk,
                                                     composite_tiles_plain, pack_sorted)
    from ex4dgs_tpu_torch.rendering import (composite_projected, composite_projected_slabs,
                                            preprocess_points)

    model, cfg, cam, _total, capacity = scene
    bg = torch.zeros(3, device=dev)
    gx, gy = tile_grid(cam.width, cam.height)
    fields = ("render", "depth", "opticalflow", "acc", "dominent_idxs")
    errs = {"composite_fwd": 0.0, "composite_bwd": 0.0}
    times = {"composite_fwd": {}, "composite_bwd": {}}
    caps = {}
    with torch.no_grad():
        pts = point_data_at_t(model, cfg, 1.0)
        proj, colors = preprocess_points(pts, cam, cfg, near=cfg.near, far=cfg.far)
        flow = torch.zeros((proj.xy.shape[0], 3), device=dev)
        ref = composite_projected(proj, colors, flow, cam, bg=bg, far=cfg.far,
                                  capacity=capacity, track_idx=True)
        for G in SLAB_COUNTS:
            caps[G], totals = worst_slab_capacity(proj, gx, gy, G, capacity)
            log(f"# slabs: G={G}, {-(-gy // G)} tile rows each: instances per slab {totals} "
                f"(whole frame {int(ref.binning_total)}); worst-slab effective total "
                f"{G * max(totals)}, sharded capacity {caps[G]} ({caps[G] // G} per slab)")
        torch.cuda.synchronize()
        kernels.reset_launches()
        outs = {G: composite_projected_slabs(proj, colors, flow, cam, bg=bg, far=cfg.far,
                                             capacity=caps[G], axis_size=G, track_idx=True)
                for G in SLAB_COUNTS}
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        for G, out in outs.items():
            same = {f: torch.equal(getattr(out, f), getattr(ref, f)) for f in fields}
            log(f"# slabs: G={G} frame bit-equal to the unsharded render: {same}; "
                f"binning_total {int(out.binning_total)} <= {caps[G]}")
            if not all(same.values()) or int(out.binning_total) > caps[G]:
                fail(f"the {G}-slab frame differs from the unsharded render or overflows")
        if launches != {**dict.fromkeys(launches, 0), "composite_fwd": sum(SLAB_COUNTS)}:
            fail(f"slabs: launches {launches}, expected one of kernel A per slab")
        del outs

        # Each slab's tiles are the whole frame's tiles t0 .. t0 + L - 1 (the
        # last slab's padding tiles past the grid are empty): kernel A's rows
        # and, on the whole frame's cotangents, kernel B's columns must be the
        # whole frame's launch's, bit for bit.
        frame = pack_frame(scene)
        kw = dict(grid_x=gx, tile_x=32, tile_y=16, track_idx=True)
        whole = kernels.composite_fwd(frame.data, frame.gid, frame.starts, frame.stops, **kw)
        cot = cotangents(whole[0])  # phase 5's cotangents of the bench frame
        d_whole = kernels.composite_bwd(frame.data, frame.starts, frame.stops, *cot, whole[1],
                                        grid_x=gx, tile_x=32, tile_y=16)
        T = gx * gy
        for G in SLAB_COUNTS:
            rows = -(-gy // G)
            L = rows * gx
            for r in range(G):
                b = bin_gaussians(proj, gx, gy, caps[G] // G, row0=r * rows, rows=rows,
                                  total_tiles=T)
                data, gid = pack_sorted(proj, colors, flow, b)
                t0 = r * rows * gx
                n = min(L, T - t0)  # the slab's tiles inside the grid
                args = (data, gid, b.tile_start, b.tile_stop)
                kw = dict(grid_x=gx, tile_x=32, tile_y=16, track_idx=True, tile0=t0)
                got = kernels.composite_fwd(*args, **kw)
                sliced = []
                for c in cot:
                    x = torch.zeros((L, *c.shape[1:]), device=dev)
                    x[:n] = c[t0:t0 + n]
                    sliced.append(x)
                bargs = (data, b.tile_start, b.tile_stop, *sliced, got[1])
                bkw = dict(grid_x=gx, tile_x=32, tile_y=16, tile0=t0)
                d_k = kernels.composite_bwd(*bargs, **bkw)
                lo, hi = int(b.tile_start[0]), int(b.tile_stop[-1])
                ws, we = int(frame.starts[t0]), int(frame.stops[t0 + n - 1])
                rows_equal = all(torch.equal(a[:n], w[t0:t0 + n]) for a, w in zip(got, whole))
                cols_equal = (lo, hi - lo) == (0, we - ws) and torch.equal(
                    d_k[:, lo:hi], d_whole[:, ws:we])
                ms_a = cuda_ms(lambda: kernels.composite_fwd(*args, **kw), reps=20)
                ms_b = cuda_ms(lambda: kernels.composite_bwd(*bargs, **bkw), reps=20)
                times["composite_fwd"].setdefault(G, []).append(ms_a)
                times["composite_bwd"].setdefault(G, []).append(ms_b)
                note = (f"A rows bit-equal to the whole frame's launch {rows_equal}, B columns "
                        f"on the whole frame's cotangents bit-equal to its {cols_equal}")
                if not (rows_equal and cols_equal):
                    fail(f"slab {r} of {G}: {note}")
                if r == 0 or hi == lo:  # tile0 = 0 is phases 3 and 5's path
                    continue
                again = kernels.composite_fwd(*args, **kw)
                note_a, ok_a, err_a = fwd_agreement(got, again, composite_tiles_plain(
                    *args, **kw), cfg.far)
                d_k2 = kernels.composite_bwd(*bargs, **bkw)
                d_p = composite_tiles_bwd_plain(*bargs, **bkw)
                # The floor of BWD_ATOL is the slab's largest gradient, not the
                # frame's: where the plain version misses the limit against
                # itself walked one instance at a time, hold B within
                # HARD_FRAME_RATIO times that spread, as phase 12 does.
                spread = None
                if any(e[1] > 1 for e in bwd_errors(d_k, d_p, lo, hi).values()):
                    spread = bwd_errors(composite_tiles_bwd_plain(*bargs, chunk=1, **bkw), d_p,
                                        lo, hi)
                note_b, ok_b, err_b = bwd_agreement(
                    d_k, d_k2, d_p, composite_tiles_bwd_walk(*bargs, **bkw), lo, hi,
                    spread=spread)
                log(f"# slab {r} of {G} (tile0 {t0}, {hi - lo} instances): {note}; "
                    f"composite_fwd vs plain: {note_a}; composite_bwd vs plain: {note_b}"
                    + ("" if spread is None else "; the plain version at chunk=1 against "
                       "itself, worst err/limit " + ", ".join(
                           f"{k} {e[1]:.3g}" for k, e in spread.items())))
                if not (ok_a and ok_b):
                    fail(f"a kernel disagrees with its plain version on slab {r} of {G}")
                errs["composite_fwd"] = max(errs["composite_fwd"], err_a)
                errs["composite_bwd"] = max(errs["composite_bwd"], err_b)

        # a first tile that does not start a row: the whole frame's tiles
        # from grid_x + 1 against the plain version and the whole frame's launch
        t0 = gx + 1
        kw = dict(grid_x=gx, tile_x=32, tile_y=16, track_idx=True)
        args = (frame.data, frame.gid, frame.starts[t0:].contiguous(),
                frame.stops[t0:].contiguous())
        got = kernels.composite_fwd(*args, tile0=t0, **kw)
        again = kernels.composite_fwd(*args, tile0=t0, **kw)
        note_a, ok_a, err_a = fwd_agreement(got, again, composite_tiles_plain(
            *args, tile0=t0, **kw), cfg.far)
        rows_equal = all(torch.equal(a, w[t0:]) for a, w in zip(got, whole))
        bkw = dict(grid_x=gx, tile_x=32, tile_y=16)
        bargs = (frame.data, args[2], args[3], *(a[t0:].contiguous() for a in (*cot, whole[1])))
        d_k = kernels.composite_bwd(*bargs, tile0=t0, **bkw)
        lo, hi = int(args[2][0]), int(args[3][-1])
        berr = bwd_errors(d_k, composite_tiles_bwd_plain(*bargs, tile0=t0, **bkw), lo, hi)
        cols_equal = torch.equal(d_k[:, lo:hi], d_whole[:, lo:hi])
        log(f"# tiles from {t0} (not a row start; grid_x {gx}): composite_fwd vs plain: "
            f"{note_a}; rows bit-equal to the whole frame's launch {rows_equal}; "
            f"composite_bwd columns bit-equal to the whole frame's {cols_equal}, vs plain "
            f"worst err/limit " + ", ".join(f"{k} {e[1]:.3g}" for k, e in berr.items()))
        if not (ok_a and rows_equal and cols_equal and all(e[1] <= 1 for e in berr.values())):
            fail("the kernels at a tile0 inside a row disagree")
        errs["composite_fwd"] = max(errs["composite_fwd"], err_a)
        errs["composite_bwd"] = max(errs["composite_bwd"], max(e[0] for e in berr.values()))
    for name, by_g in times.items():
        log(f"# slabs: {name} CUDA-event ms per slab " + "; ".join(
            f"G={G} " + ", ".join(f"{t:.4f}" for t in ts) + f" (sum {sum(ts):.4f}, slowest "
            f"{max(ts):.4f})" for G, ts in by_g.items())
            + f"; whole frame {whole_ms[name]:.4f} ms (phases 3 and 5); {card}")
    return {name: {"slab_launches": launches[name], "slab_max_abs_err": errs[name],
                   "slab_ms": {str(G): ts for G, ts in times[name].items()}}
            for name in errs}, caps


def nccl_one_phase(dev, scene, train_ms: float, card: str) -> dict:
    """16.2: the sharded step on a world of one rank over NCCL, at mesh
    (1, 1), against train_step, and timed by bench.py's recipe. Returns the
    kernels' launches in its checked steps."""
    import torch.distributed as dist

    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench import measure
    from ex4dgs_tpu_torch.io.checkpoint import digest
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.density import pull
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.parallel import make_mesh
    from ex4dgs_tpu_torch.parallel.step_dp import make_sharded_train_step
    from ex4dgs_tpu_torch.runtime.distributed import initialize
    from ex4dgs_tpu_torch.train.step import StepStatics, clone_state, train_step

    model, cfg, cam, _total, capacity = scene
    info = initialize(f"localhost:{free_port()}", 1, 0, device=dev, timeout=120)
    try:
        mesh = make_mesh(1, data=1, gauss=1, device=dev)
        statics = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=3.0,
                              capacity=capacity)
        gt = torch.zeros((cam.height, cam.width, 3), device=dev)
        bg = torch.zeros(3, device=dev)
        state = init_state(model.params, device=dev)
        step = make_sharded_train_step(statics, mesh, device=dev)
        ref = train_step(*clone_state(model, state), cam, gt, 1.0, bg, 100, statics, device=dev)
        step(model, state, cam, gt, 1.0, bg, 100)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        a = step(model, state, cam, gt, 1.0, bg, 100)
        b = step(model, state, cam, gt, 1.0, bg, 100)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        d_ref, d_a, d_b = (digest(pull(o.model, o.opt_state)) for o in (ref, a, b))
        timing = measure(lambda i: step(model, state, cam, gt, float(i % 5), bg, 100), 20, 3,
                         dev)
        backend = dist.get_backend()
        torch.cuda.reset_peak_memory_stats()
        report_profile("sharded step (1, 1) over NCCL, t=1",
                       lambda: step(model, state, cam, gt, 1.0, bg, 100), card, timing.ms)
    finally:
        dist.destroy_process_group()
    log(f"# sharded step, world 1 over {backend} ({info}), mesh (1, 1): bit-equal to "
        f"train_step {d_a == d_ref}, two steps from one state bit-equal {d_a == d_b}; loss "
        f"{a.loss.item():.6f} (train_step {ref.loss.item():.6f}); launches {launches}; "
        f"{timing.ms:.3f} ms/iteration by bench.py's recipe (windows "
        + ", ".join(f"{w:.3f}" for w in timing.windows_ms)
        + f") against train_step's {train_ms:.3f} "
        f"(phase 8); {card}")
    if backend != ("nccl" if dev.type == "cuda" else "gloo") or d_a != d_ref or d_a != d_b:
        fail("the NCCL (1, 1) sharded step is not train_step's, or not deterministic")
    if launches != {**dict.fromkeys(launches, 0), "composite_fwd": 2, "composite_bwd": 2,
                    "pack_vjp": 2}:
        fail(f"the (1, 1) sharded step launched {launches}, expected one A, one B and one pack "
             f"VJP a step")
    return {"nccl_launches": launches, "nccl_ms": timing.ms}


def _gloo_rank(rank: int, port: int, caps: dict, out_dir: str, device: str,
               scene_fn) -> None:
    """16.3, one of two ranks on the one card over gloo: the state of
    scene_fn (the bench scene) through the sharded step at each of
    GLOO_MESHES. Saves rank<r>.pt."""
    import torch.distributed as dist

    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.io.checkpoint import digest
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.density import pull
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.parallel import make_mesh
    from ex4dgs_tpu_torch.parallel.step_dp import make_sharded_train_step, replicate
    from ex4dgs_tpu_torch.runtime.distributed import initialize
    from ex4dgs_tpu_torch.train.step import StepStatics

    info = initialize(f"localhost:{port}", 2, rank, device=device, backend="gloo",
                      timeout=RANK_TIMEOUT)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device(device)
    model, cfg, cam, _total, _capacity = scene_fn(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gt = torch.zeros((cam.height, cam.width, 3), device=dev)
    bg = torch.zeros(3, device=dev)
    results = {"info": info, "device": str(dev)}
    for data, gauss in GLOO_MESHES:
        mesh = make_mesh(2, data=data, gauss=gauss, device=dev)
        m = replicate(model, mesh)
        state = replicate(init_state(m.params, device=dev), mesh)
        statics = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=3.0,
                              capacity=caps[gauss])
        step = make_sharded_train_step(statics, mesh, device=dev)
        step(m, state, cam, gt, 1.0, bg, 100)  # warm-up
        sync()
        kernels.reset_launches()
        out = step(m, state, cam, gt, 1.0, bg, 100)
        sync()
        launches = dict(kernels.launches)
        hm = pull(out.model, out.opt_state)
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(5):
                step(m, state, cam, gt, float(i % 5), bg, 100)
            sync()
            windows.append((time.perf_counter() - t0) / 5 * 1e3)
        results[(data, gauss)] = dict(
            params=hm.params, mu=hm.mu, denom=hm.stats["denom"], loss=float(out.loss),
            total=int(out.binning_total), capacity=caps[gauss], nan=bool(out.nan_flag),
            digest=digest(hm), launches=launches, windows=windows)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_ranks(target, n: int, args: tuple, timeout: int) -> None:
    """target(rank, *args) on n spawned processes; fails (killing them all)
    if one fails or any runs past `timeout` seconds."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    if codes != [0] * n:
        fail(f"spawned ranks exited {codes} (None: killed at the {timeout} s limit)")


def gloo_two_phase(dev, scene, scene_fn, caps: dict, train_ms: float, card: str,
                   tmp: str) -> dict:
    """16.3: two ranks on the one card over gloo, at meshes (1, 2) and
    (2, 1), each held to train_step from the same state at
    tests/test_parallel.py's tolerances and its gradient (the first step's
    mu) at tests/test_torch_train.py's moment tolerance. Returns the kernels' launches in
    the checked steps, summed over the ranks and meshes, and the step
    times."""
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.density import pull
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.train.step import StepStatics, clone_state, train_step

    model, cfg, cam, _total, capacity = scene
    statics = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=3.0,
                          capacity=capacity)
    gt = torch.zeros((cam.height, cam.width, 3), device=dev)
    ref_out = train_step(*clone_state(model, init_state(model.params, device=dev)), cam, gt,
                         1.0, torch.zeros(3, device=dev), 100, statics, device=dev)
    ref = pull(ref_out.model, ref_out.opt_state)
    ref_loss = ref_out.loss.item()
    del ref_out
    out_dir = os.path.join(tmp, "gloo_ranks")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    run_ranks(_gloo_rank, 2, (free_port(), {1: capacity, 2: caps[2]}, out_dir, dev.type,
                              scene_fn), RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    launches = {"composite_fwd": 0, "composite_bwd": 0}
    ms = {}
    for mesh in GLOO_MESHES:
        outs = [rk[mesh] for rk in ranks]
        o = outs[0]
        worst, mu_err = {}, {}
        ok = True
        for k, v in o["params"].items():
            if v.size == 0:
                continue
            close = np.isclose(v, ref.params[k], rtol=2e-4, atol=5e-5).mean()
            dmax = float(np.abs(v - ref.params[k]).max())
            worst[k] = (close, dmax)
            ok &= close > 0.95 and dmax < 2e-3
            # The first step's mu is 0.1 x its gradient; the parameters
            # alone would pass a gradient off by a small factor (the first
            # RAdam step moves them by lr x gradient). Held at
            # tests/test_torch_train.py's moment tolerance.
            want_mu = ref.mu[k]
            mu_atol = 1e-5 * float(np.abs(want_mu).max())
            mu_diff = np.abs(o["mu"][k] - want_mu)
            mu_err[k] = float(mu_diff.max())
            ok &= bool((mu_diff <= mu_atol + 1e-5 * np.abs(want_mu)).all())
        loss_ok = abs(o["loss"] - ref_loss) <= 1e-4 * abs(ref_loss)
        denom_ok = np.allclose(o["denom"], ref.stats["denom"] * mesh[0], atol=1e-5)
        same = len({x["digest"] for x in outs}) == 1
        want = {"composite_fwd": 1, "composite_bwd": 1, "pack_vjp": 1}
        launch_ok = all(x["launches"] == {**dict.fromkeys(x["launches"], 0), **want}
                        for x in outs)
        for x in outs:
            for name in launches:
                launches[name] += x["launches"][name]
        ms[f"{mesh[0]}x{mesh[1]}"] = min(min(x["windows"]) for x in outs)
        log(f"# gloo, 2 ranks on {ranks[0]['device']} ({ranks[0]['info']}), mesh {mesh}: "
            f"loss {o['loss']:.6f} vs train_step {ref_loss:.6f} (rtol 1e-4) {loss_ok}; params "
            f"(share within rtol 2e-4/atol 5e-5, max |diff|) "
            + ", ".join(f"{k} {c:.4f} {d:.3g}" for k, (c, d) in worst.items())
            + "; mu (the gradient; rtol 1e-5, atol 1e-5 of max |mu|) max |diff| "
            + ", ".join(f"{k} {e:.3g}" for k, e in mu_err.items())
            + f"; denom x{mesh[0]} {denom_ok}; ranks digest-equal {same}; binning_total "
            f"{o['total']} <= capacity {o['capacity']}; launches per rank "
            f"{[x['launches'] for x in outs]}; ms/iteration (best of 3 windows of 5, each "
            f"rank) {[round(min(x['windows']), 3) for x in outs]} against train_step's "
            f"{train_ms:.3f} (phase 8); {card}")
        if not (ok and loss_ok and denom_ok and same and launch_ok):
            fail(f"the gloo sharded step at mesh {mesh} disagrees with train_step")
        if any(x["total"] > x["capacity"] or x["nan"] for x in outs):
            fail(f"the gloo sharded step at mesh {mesh} overflowed or raised the NaN flag")
    log(f"# gloo phase: {wall:.1f} s for both ranks (start-up, bench scene, both meshes)")
    return {"gloo_launches": launches, "gloo_ms": ms}


def cli_two_phase(dev, scene_dir: str, card: str, tmp: str) -> dict:
    """16.4: the training CLI as two ranks on the one card over gloo,
    --mesh_data 2, on phase 12's scene for CLI16_ITERS iterations. Returns
    rank 0's launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(root, "configs", "N3V", "n3v_base.json")
    out = os.path.join(tmp, "model16")
    port = free_port()
    base = [sys.executable, "-m", "ex4dgs_tpu_torch.train", "--config", config,
            "--source_path", scene_dir, "--model_path", out, "--quiet", *TRAIN_SCHEDULE,
            "--iterations", str(CLI16_ITERS), "--mesh_data", "2", "--mesh_gauss", "1",
            "--coordinator", f"localhost:{port}", "--num_processes", "2",
            "--dist_backend", "gloo", *(["--device", "cpu"] if dev.type == "cpu" else [])]
    logs = [open(os.path.join(tmp, f"cli16_rank{r}.log"), "w+") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(base + ["--process_id", str(r)], cwd=root, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        codes = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if codes != [0, 0]:
        for f in logs:
            f.seek(0)
            log(f.read()[-4000:])
        fail(f"the 2-rank training CLI exited {codes}")
    with open(os.path.join(out, "train_report.json")) as f:
        report = json.load(f)
    report["wall_s"] = wall
    trainer_report_lines(f"2-rank trainer CLI (--mesh_data 2, gloo, {CLI16_ITERS} "
                         f"iterations, rank 0's report)", report, card)
    digests = report["rank_digests"][str(CLI16_ITERS)]
    losses = np.asarray(report["loss"])
    early, late = losses[:10].mean(), losses[-10:].mean()
    log(f"# 2-rank trainer CLI: {report['distributed']}, mesh {report['mesh']}; rank "
        f"digests at {CLI16_ITERS} equal {len(set(digests)) == 1} ({digests[0][:16]}); loss "
        f"{early:.6f} (first 10) -> {late:.6f} (last 10); events {report['event_counts']}")
    if len(digests) != 2 or len(set(digests)) != 1:
        fail("the 2-rank trainer's ranks ended with different models")
    if not (np.isfinite(losses).all() and late < early):
        fail("the 2-rank trainer's losses are not finite or did not fall")
    if report["event_counts"].get("densify_and_prune", 0) < 1:
        fail("the 2-rank trainer crossed no density event")
    check_launches("2-rank trainer CLI, rank 0", report)
    return {name: report["kernel_launches"][name] for name in ("composite_fwd",
                                                              "composite_bwd")}


def multi_gpu_phase(dev, whole_ms: dict, train_ms: float, scene_dir: str, card: str,
                    tmp: str, scene_fn=None) -> dict:
    """Phase 16: 16.1 slabs in one process, 16.2 NCCL world 1, 16.3 two
    gloo ranks on the card, 16.4 the 2-rank trainer CLI, on scene_fn's
    scene (default the bench scene) and phase 12's scene_dir. Returns the
    kernels' fields for the kernels line."""
    from ex4dgs_tpu_torch.bench_frame import bench_scene

    scene_fn = scene_fn or bench_scene
    scene = scene_fn(dev)
    t = [time.perf_counter()]

    def mark():
        t.append(time.perf_counter())
        return t[-1] - t[-2]

    slabs, caps = slab_phase(dev, scene, whole_ms, card)
    s1 = mark()
    nccl = nccl_one_phase(dev, scene, train_ms, card)
    s2 = mark()
    gloo = gloo_two_phase(dev, scene, scene_fn, caps, train_ms, card, tmp)
    s3 = mark()
    del scene
    torch.cuda.empty_cache()
    cli = cli_two_phase(dev, scene_dir, card, tmp)
    s4 = mark()
    log(f"# phase 16 parts (s): slabs {s1:.1f}, NCCL world 1 {s2:.1f}, gloo 2 ranks {s3:.1f}, "
        f"2-rank CLI {s4:.1f}")
    out = {}
    for name in ("composite_fwd", "composite_bwd"):
        out[name] = {**slabs[name], "nccl_launches": nccl["nccl_launches"][name],
                     "gloo_launches": gloo["gloo_launches"][name], "cli16_launches": cli[name],
                     "multi_gpu_launches": (slabs[name]["slab_launches"]
                                            + nccl["nccl_launches"][name]
                                            + gloo["gloo_launches"][name] + cli[name])}
    out["composite_bwd"].update(nccl_step_ms=nccl["nccl_ms"], gloo_step_ms=gloo["gloo_ms"])
    return out


# Phase 17: the bench entry point, as a user runs it.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "train_step_mpix_s", "render_mpix_s",
              "render_noidx_mpix_s", "instances", "capacity", "resolution", "kernel_config")
BENCH_LAUNCHES = {"fwd_bwd": {"composite_fwd": 1, "composite_bwd": 1},
                  "train_step": {"composite_fwd": 1, "composite_bwd": 1},
                  "render": {"composite_fwd": 1, "composite_bwd": 0},
                  "render_noidx": {"composite_fwd": 1, "composite_bwd": 0}}
BENCH_TIMEOUT = 300  # seconds for one run of the bench
BENCH_16X16 = {"EX4DGS_TILE": "16x16", "EX4DGS_EXACT_SORT": "1", "BENCH_ITERS": "2",
               "BENCH_REPEATS": "1"}


def run_bench(env: dict, card: str) -> dict:
    """python -m ex4dgs_tpu_torch.bench from the repo root with `env` added
    to the environment, under BENCH_TIMEOUT; logs its lines and returns its
    last line's object, checked: bench.py's keys in order, finite positive
    rates, times and busy share, instances within the capacity, the
    launches per call of BENCH_LAUNCHES, and a card that names this one."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ex4dgs_tpu_torch.bench"], cwd=root,
                         env={**os.environ, **env}, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        log(out.stdout[-3000:])
        log(out.stderr[-6000:])
        fail(f"the bench exited {out.returncode} under {env}")
    for line in lines[:-1]:
        if not line.startswith("#"):
            fail(f"the bench printed a line that is not a comment before its result: {line}")
        log(f"#   {line}")
    got = json.loads(lines[-1])
    log(f"# bench {env or 'defaults'} ({wall:.1f} s): {lines[-1]}")
    if tuple(got)[:len(BENCH_KEYS)] != BENCH_KEYS:
        fail(f"the bench's keys {list(got)} do not start with bench.py's {list(BENCH_KEYS)}")
    if got["metric"] != "rasterizer_fwd_bwd_throughput" or got["unit"] != "Mpixels/s/chip":
        fail(f"the bench's metric or unit: {got['metric']}, {got['unit']}")
    numbers = ("value", "vs_baseline", "train_step_mpix_s", "render_mpix_s",
               "render_noidx_mpix_s", "fwd_bwd_ms", "train_step_ms", "render_ms",
               "render_noidx_ms", "composite_fwd_ms", "composite_bwd_ms",
               "train_step_device_ms", "device_busy_share")
    bad = [k for k in numbers if not (isinstance(got[k], float) and math.isfinite(got[k])
                                      and got[k] > 0)]
    if bad or got["device_busy_share"] > 1:
        fail(f"the bench's {bad or 'device_busy_share'} not finite and positive (share <= 1)")
    if not 0 < got["instances"] <= got["capacity"]:
        fail(f"the bench's {got['instances']} instances and capacity {got['capacity']}")
    per_call = {k: got["launches"][k] for k in BENCH_LAUNCHES}
    if per_call != BENCH_LAUNCHES:
        fail(f"the bench's launches per call {per_call}, expected {BENCH_LAUNCHES}")
    if got["card"] != card:
        fail(f"the bench names the card {got['card']!r}, nvidia-smi {card!r}")
    return got


def bench_16x16_hold(dev, run: dict, card: str) -> dict:
    """Kernels A and B on the bench frame at t=1 at the shape of the bench's
    16x16 run (`run`, its line): 16x16 tiles, the exact depth sort, the
    capacity the bench sized from its probe. A against its plain version as
    phase 3 holds it; B against its twin (bit-equal) and its plain version
    as phase 5 holds it. Returns each kernel's largest difference from
    plain. These launches are not the main path's and are not counted."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import bench_scene, cotangents, pack_frame
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.ops.rasterize_cuda import (BWD_ATOL, BWD_RTOL,
                                                     composite_tiles_bwd_plain,
                                                     composite_tiles_bwd_walk,
                                                     composite_tiles_plain)

    tx, ty = 16, 16
    scene = bench_scene(dev, kernel_cfg=KernelConfig(tile_x=tx, tile_y=ty, exact_sort=True))
    if (scene.total, scene.capacity) != (run["instances"], run["capacity"]):
        fail(f"the 16x16 bench frame holds {scene.total} instances in {scene.capacity} slots, "
             f"the bench's run {run['instances']} in {run['capacity']}")
    data, gid, starts, stops, gx, n_points = pack_frame(scene, tx, ty, exact_sort=True)
    args = (data, gid, starts, stops)
    kw = dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True)
    got = kernels.composite_fwd(*args, **kw)
    again = kernels.composite_fwd(*args, **kw)
    want = composite_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    note, ok, err_fwd = fwd_agreement(got, again, want, scene.cfg.far)
    log(f"# bench frame 16x16, exact sort ({scene.total} instances, capacity "
        f"{scene.capacity}), composite_fwd vs plain: {note}")
    if not ok:
        fail("composite_fwd disagrees with its plain version at 16x16 with the exact sort")
    if not bool((got[2] >= -1).all()) or int(got[2].max().item()) >= n_points:
        fail("composite_fwd wrote an id outside [-1, P) at 16x16")
    acc, tfinal, _ = got
    del again, want
    bargs = (data, starts, stops, *cotangents(acc), tfinal)
    bkw = dict(grid_x=gx, tile_x=tx, tile_y=ty)
    d_k = kernels.composite_bwd(*bargs, **bkw)
    d_k2 = kernels.composite_bwd(*bargs, **bkw)
    d_p = composite_tiles_bwd_plain(*bargs, **bkw)
    twin = composite_tiles_bwd_walk(*bargs, **bkw)
    torch.cuda.synchronize()
    note, ok, err_bwd = bwd_agreement(d_k, d_k2, d_p, twin, int(starts[0].item()),
                                      int(stops[-1].item()))
    log(f"# bench frame 16x16, exact sort, composite_bwd vs plain, per element |kernel - "
        f"plain| <= {BWD_RTOL:g} |plain| + {BWD_ATOL:g} max |plain| per row group: {note}; "
        f"{card}")
    if not ok:
        fail("composite_bwd disagrees with its plain version or its twin at 16x16 with the "
             "exact sort")
    return {"composite_fwd": err_fwd, "composite_bwd": err_bwd}


def bench_phase(dev, card: str) -> dict:
    """17: the bench entry point at its defaults, then at 16x16 with the
    exact sort, then kernels A and B held at that run's shape. Returns the
    kernels' launches over both runs and their 16x16 differences from
    plain."""
    runs = {}
    for name, env, tile in (("default", {}, (32, 16, False)),
                            ("16x16", BENCH_16X16, (16, 16, True))):
        got = runs[name] = run_bench(env, card)
        kc = got["kernel_config"]
        if (kc["tile_x"], kc["tile_y"], kc["exact_sort"], kc["tight_cull"]) != (*tile, False):
            fail(f"the bench under {env} ran at {kc}")
    if not runs["16x16"]["instances"] > runs["default"]["instances"]:
        fail(f"16x16 tiles gave {runs['16x16']['instances']} instances, 32x16 "
             f"{runs['default']['instances']}")
    err = bench_16x16_hold(dev, runs["16x16"], card)
    return {name: {"bench_launches": sum(r["launches"]["run"][name] for r in runs.values()),
                   "bench_16x16_max_abs_err": err[name]}
            for name in ("composite_fwd", "composite_bwd")}


def bench_alone() -> int:
    """Phase 17 alone (`python3 chip_smoke.py --only 17`): the kernels
    built, then the bench entry point's two runs."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from ex4dgs_tpu_torch import kernels

    card = card_line()
    kernels.load_all()
    t0 = time.perf_counter()
    out = bench_phase(torch.device("cuda"), card)
    log(f"# phase 17 {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


# -- 18. the slicing kernel pair (4D Gaussian Splatting) --------------------

SLICE_ROWS = 500_000  # the n3v_4dgs cell's Gaussians, in a capacity of 503,808 rows
SLICE_SPAN = 10.0  # seconds: the cell's time span
SLICE_W, SLICE_H = 1352, 1014
# the cell's degrees, then pairs below SH degree 3 (where the backward once
# left the basis's cotangent past the active degree unzeroed) and time
# degree 0
SLICE_DEGREES = ((3, 2), (2, 2), (2, 1), (1, 0), (0, 0))
SLICE_LIVE_SLACK = 10  # rows whose 0.05 marginal test may flip at a rounding


def rel_err(a, b) -> float:
    """Largest |a - b| over the largest |b| (the difference itself where b
    is all 0)."""
    diff = float((a.double() - b.double()).abs().max())
    den = float(b.double().abs().max())
    return diff / den if den > 0 else diff


def fourdgs_scene(dev, rows: int = SLICE_ROWS, seed: int = 18):
    """A Gaussian4DModel shaped as the n3v_4dgs cell's
    (gsbench/configs/n3v_4dgs.json): `rows` active 4D Gaussians in the
    port's rounded capacity at SH degree 3 x time degree 2 (48 feature
    rows); a cloud of std 2.4, time means uniform over the span, log-scales
    uniform in log [0.018, 0.09] and log [0.4, 0.9] s, each quaternion pair
    a 3D orientation (rotating xyz, fixing t) perturbed by N(0, 0.15) so
    that space and time mix, opacities uniform in [0.15, 0.95]; the rows
    past them as empty_model leaves them."""
    from ex4dgs_tpu_torch.models.config import Model4DConfig
    from ex4dgs_tpu_torch.models.state4d import empty_model
    from ex4dgs_tpu_torch.ops.math3d import SH_C0

    model = empty_model(Model4DConfig(time_duration=(0.0, SLICE_SPAN)), rows, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=g, **f32)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, **f32)

    def unit(q):
        return q / torch.linalg.norm(q, dim=-1, keepdim=True)

    u = unit(normal(rows, 4))
    flip = torch.tensor([1.0, -1.0, -1.0, 1.0], **f32)
    n_rest = model.params["f_rest"].shape[1]
    new = {"xyz": normal(rows, 3) * 2.4, "t": uniform(0.0, SLICE_SPAN, rows, 1),
           "scaling": uniform(math.log(0.018), math.log(0.09), rows, 3),
           "scaling_t": uniform(math.log(0.4), math.log(0.9), rows, 1),
           "rotation": unit(u + 0.15 * normal(rows, 4)),
           "rotation_r": unit(u * flip + 0.15 * normal(rows, 4)),
           "opacity": torch.logit(uniform(0.15, 0.95, rows, 1)),
           "f_dc": (uniform(0.05, 0.95, rows, 1, 3) - 0.5) / SH_C0,
           "f_rest": normal(rows, n_rest, 3) * 0.08}
    for k, v in new.items():
        model.params[k][:rows] = v
    model.mask[:rows] = True
    i32 = dict(dtype=torch.int32, device=dev)
    return model.replace(active_sh_degree=torch.tensor(3, **i32),
                         active_sh_degree_t=torch.tensor(2, **i32))


def slice4d_phase(dev, card: str) -> tuple[list[dict], int]:
    """Phase 18 (see the module's docstring). Returns the kernels line's
    entries of slice4d_fwd and slice4d_bwd, and the pack VJP's launches in
    the three train_step_4d calls."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import cuda_ms
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.models.config import Model4DConfig, Optimization4DConfig
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.ops import slice4d as S
    from ex4dgs_tpu_torch.rendering import default_capacity
    from ex4dgs_tpu_torch.synthetic import ring_cameras
    from ex4dgs_tpu_torch.train import step as step_mod

    model = fourdgs_scene(dev)
    P = model.capacity
    params = [model.params[k] for k in S.PARAMS]
    mask = model.mask
    t = torch.tensor(3.7, device=dev)
    campos = torch.tensor([1.5, 4.0, -11.5], device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    cots = [torch.randn(s, generator=g, device=dev) for s in ((P, 3), (P, 6), (P,), (P, 3))]
    worst = {"slice4d_fwd": 0.0, "slice4d_bwd": 0.0}
    for deg, deg_t in SLICE_DEGREES:
        d = torch.tensor(deg, dtype=torch.int32, device=dev)
        d_t = torch.tensor(deg_t, dtype=torch.int32, device=dev)
        fwd = kernels.slice4d_fwd(*params, mask, t, campos, d, d_t, span=SLICE_SPAN)
        fwd2 = kernels.slice4d_fwd(*params, mask, t, campos, d, d_t, span=SLICE_SPAN)
        want = S.slice4d_plain(*params, mask, t, campos, d, d_t, span=SLICE_SPAN)
        err_f = max(rel_err(a, b) for a, b in zip(fwd[:4], want[:4]))
        flips = int((fwd[4] != want[4]).sum())
        bwd = kernels.slice4d_bwd(*params, t, campos, d, d_t, *cots, span=SLICE_SPAN)
        bwd2 = kernels.slice4d_bwd(*params, t, campos, d, d_t, *cots, span=SLICE_SPAN)
        errs_b = [rel_err(a, b) for a, b in zip(bwd, S.slice4d_bwd_plain(
            *params, t, campos, d, d_t, *cots, span=SLICE_SPAN))]
        err_b = max(errs_b)
        same = (all(torch.equal(a, b) for a, b in zip(fwd, fwd2))
                and all(torch.equal(a, b) for a, b in zip(bwd, bwd2)))
        log(f"# slice4d degrees ({deg}, {deg_t}) at {P} rows ({int(fwd[4].sum())} live): "
            f"forward {err_f:.3g} of each output's largest (<= {S.SLICE_RTOL:g}), "
            f"{flips} live flips (<= {SLICE_LIVE_SLACK}); backward {err_b:.3g} of each leaf's "
            f"largest (<= {S.SLICE_BWD_RTOL:g}; worst {S.PARAMS[errs_b.index(err_b)]}); "
            f"two launches bit-equal: {same}")
        if not (err_f <= S.SLICE_RTOL and flips <= SLICE_LIVE_SLACK
                and err_b <= S.SLICE_BWD_RTOL and same):
            fail(f"the slicing kernels disagree with their plain versions at degrees "
                 f"({deg}, {deg_t})")
        worst["slice4d_fwd"] = max(worst["slice4d_fwd"], err_f)
        worst["slice4d_bwd"] = max(worst["slice4d_bwd"], err_b)
        del fwd, fwd2, want, bwd, bwd2

    # times at the cell's degrees (the last pair's tensors are rebuilt)
    d = torch.tensor(3, dtype=torch.int32, device=dev)
    d_t = torch.tensor(2, dtype=torch.int32, device=dev)
    fwd = kernels.slice4d_fwd(*params, mask, t, campos, d, d_t, span=SLICE_SPAN)
    bwd = kernels.slice4d_bwd(*params, t, campos, d, d_t, *cots, span=SLICE_SPAN)

    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    moved = {"slice4d_fwd": nbytes(*params, mask, *fwd), "slice4d_bwd": nbytes(*params, *cots,
                                                                               *bwd)}
    ms = {"slice4d_fwd": cuda_ms(lambda: kernels.slice4d_fwd(
              *params, mask, t, campos, d, d_t, span=SLICE_SPAN), reps=50),
          "slice4d_bwd": cuda_ms(lambda: kernels.slice4d_bwd(
              *params, t, campos, d, d_t, *cots, span=SLICE_SPAN), reps=50)}
    plain_ms = {"slice4d_fwd": cuda_ms(lambda: S.slice4d_plain(
                    *params, mask, t, campos, d, d_t, span=SLICE_SPAN), reps=3, warmup=1),
                "slice4d_bwd": cuda_ms(lambda: S.slice4d_bwd_plain(
                    *params, t, campos, d, d_t, *cots, span=SLICE_SPAN), reps=3, warmup=1)}
    bound = {k: 1e3 * v / HBM_BYTES_S for k, v in moved.items()}
    for k in ms:
        log(f"# {k}: {ms[k]:.4f} ms at {P} rows (CUDA events, 50 launches), plain "
            f"{plain_ms[k]:.4f} ms; bound {bound[k]:.4f} ms ({moved[k] / P:.0f} B a row, "
            f"{moved[k] / 1e6:.1f} MB at {HBM_BYTES_S / 1e12:.2f} TB/s), "
            f"{100 * bound[k] / ms[k]:.1f}% of it; {card}")
        if ms[k] < bound[k]:
            fail(f"{k} read {ms[k]:.4f} ms, below its bound {bound[k]:.4f} ms")
    del fwd, bwd, cots

    # the launches of the training step: eager call, capture, replay
    kcfg = KernelConfig(tile_x=16, tile_y=16, exact_sort=True).validate()
    statics = step_mod.Step4DStatics(
        cfg=Model4DConfig(time_duration=(0.0, SLICE_SPAN)), opt=Optimization4DConfig(),
        spatial_lr_scale=1.0, capacity=default_capacity(P, SLICE_W, SLICE_H, kcfg), kernel=kcfg)
    cams = ring_cameras(8, 12.0, SLICE_W, SLICE_H, device=dev)
    gts = [torch.rand((SLICE_H, SLICE_W, 3), generator=g, device=dev) for _ in range(4)]
    state = init_state(model.params, device=dev)
    step_mod._GRAPHS.clear()
    kernels.reset_launches()
    kernels.reset_graph_calls()
    outs = []
    for i in range(3):
        views = [cams[(2 * i + j) % len(cams)] for j in range(4)]
        out = step_mod.train_step_4d(model, state, views, gts,
                                     [0.9 + 2.3 * j + 0.4 * i for j in range(4)],
                                     torch.rand(3, generator=g, device=dev), 10_000 + i, statics,
                                     device=dev)
        model, state = out.model, out.opt_state
        outs.append((float(out.loss), bool(out.nan_flag), int(out.binning_total)))
    torch.cuda.synchronize()
    calls = kernels.graph_call_counts(dev)
    launched = {k: kernels.launches[k] for k in ("slice4d_fwd", "slice4d_bwd", "pack_vjp")}
    log(f"# train_step_4d x3 at {SLICE_W}x{SLICE_H}, 4 views (loss, nan, largest view's "
        f"instances of {statics.capacity}): {outs}; graph calls {calls}; launches {launched}")
    step_mod._GRAPHS.clear()
    # the second call captures the graph and replays it, the third replays
    if calls != {"eager": 1, "captures": 1, "replays": 2}:
        fail(f"train_step_4d's graph calls are {calls}, not an eager call, a capture and two "
             f"replays")
    if launched != {"slice4d_fwd": 12, "slice4d_bwd": 12, "pack_vjp": 12}:
        fail(f"the slicing kernels and the pack VJP launched {launched} times in 3 steps of 4 "
             f"views, not 12")
    if any(nan or not math.isfinite(loss) or n > statics.capacity for loss, nan, n in outs):
        fail("train_step_4d gave a non-finite loss, a NaN or an overflow")
    del model, state, params, mask, gts
    torch.cuda.empty_cache()
    return [{"name": k, "route": "cuda", "source": f"ex4dgs_tpu_torch/csrc/{k}.cu",
             "replaces": None, "launches": launched[k], "rows": P, "max_rel_err": worst[k],
             "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bound[k], "bound_by": "bytes",
             "bytes": moved[k], "library_ms": None} for k in ms], launched["pack_vjp"]


def slice4d_alone() -> int:
    """Phase 18 alone (`python3 chip_smoke.py --only 18`): the kernels
    built, then the slicing kernel pair and its kernels line."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from ex4dgs_tpu_torch import kernels

    card = card_line()
    kernels.load_all()
    t0 = time.perf_counter()
    out, _ = slice4d_phase(torch.device("cuda"), card)
    log(f"# phase 18 {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    return 0


# Phase 19: the pack VJP kernel (csrc/pack_vjp.cu) at the training cells'
# shapes. n3v: the bench scene (100k static + 10k dynamic splats) through
# one 1352x1014 view at 32x16 tiles into n3v.train's 917,504 slots;
# n3v_4dgs: phase 18's 500,000 4D Gaussians through one view at 16x16 tiles
# with the exact sort into default_capacity's 4,063,232 slots. A time above
# the limit fails, as does one below the bytes bound.
PACK_VJP_CAPACITY = {"n3v": 917_504, "n3v_4dgs": 4_063_232}
PACK_VJP_MS_LIMIT = {"n3v": 0.15, "n3v_4dgs": 0.30}
# gsbench/metrics/pack_vjp_roofline.py's count: per live instance its 16
# cotangent floats and its slot (68 B), per visible Gaussian cum, counts and
# its 16 gradient floats (72 B)
PACK_VJP_BYTES = (68, 72)


def spy_pack_inputs(fn) -> tuple:
    """(slot, cum, counts, capacity) that the render `fn()` passes to
    PackSorted: a binning exactly as the training path builds it."""
    from ex4dgs_tpu_torch.ops import rasterize_cuda as trc

    seen = []
    apply = trc.PackSorted.apply

    def spy(rows, order, cum, counts, slot):
        seen.append((slot, cum, counts, order.shape[0]))
        return apply(rows, order, cum, counts, slot)

    trc.PackSorted.apply = spy
    try:
        with torch.no_grad():
            fn()
    finally:
        trc.PackSorted.apply = apply
    return seen[0]


def scan_recipe(ct, slot, cum, counts):
    """The pack VJP as PackSorted.backward computed it before the kernel: a
    float64 inclusive prefix of the cotangent put back in expansion order,
    over the whole capacity, differenced at each Gaussian's segment ends
    (the library's version of the phase)."""
    capacity = ct.shape[1]
    slot_s = torch.empty(capacity, dtype=torch.long, device=ct.device)
    slot_s[slot.long()] = torch.arange(capacity, device=ct.device)
    pref = torch.zeros((ct.shape[0], capacity + 1), dtype=torch.float64, device=ct.device)
    torch.cumsum(ct.index_select(1, slot_s).double(), dim=1, out=pref[:, 1:])
    hi = cum.long().clamp(0, capacity)
    lo = (cum - counts).long().clamp(0, capacity)
    return (pref.index_select(1, hi) - pref.index_select(1, lo)).float()


def pack_vjp_phase(dev, card: str) -> dict:
    """Phase 19 (see the module's docstring). Returns the kernels line's
    entry of pack_vjp, without its main-path `launches`, which the caller
    counts; `microbench_launches` are this phase's own calls."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import bench_scene, cuda_ms
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.models.config import Model4DConfig
    from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
    from ex4dgs_tpu_torch.rendering import default_capacity, render, render4d
    from ex4dgs_tpu_torch.runtime.profiling import profile_calls
    from ex4dgs_tpu_torch.synthetic import ring_cameras

    bg = torch.zeros(3, device=dev)
    scene = bench_scene(dev)
    views = {"n3v": spy_pack_inputs(lambda: render(
        scene.cam, scene.model, scene.cfg, t=1.0, bg=bg, capacity=PACK_VJP_CAPACITY["n3v"],
        device=dev))}
    del scene
    model = fourdgs_scene(dev)
    kcfg = KernelConfig(tile_x=16, tile_y=16, exact_sort=True).validate()
    cam = ring_cameras(8, 12.0, SLICE_W, SLICE_H, device=dev)[3]
    if default_capacity(model.capacity, SLICE_W, SLICE_H, kcfg) != PACK_VJP_CAPACITY["n3v_4dgs"]:
        fail("n3v_4dgs's default capacity is no longer 4,063,232 slots")
    views["n3v_4dgs"] = spy_pack_inputs(lambda: render4d(
        cam, model, Model4DConfig(time_duration=(0.0, SLICE_SPAN)), t=3.7, bg=bg,
        kernel_cfg=kcfg, device=dev))
    del model
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(19)
    kernels.reset_launches()
    out = {}
    for name, (slot, cum, counts, capacity) in views.items():
        if capacity != PACK_VJP_CAPACITY[name]:
            fail(f"{name}: the render packed {capacity} slots, not {PACK_VJP_CAPACITY[name]}")
        P = cum.shape[0]
        total = int(cum[-1])
        live = min(total, capacity)
        n = counts.long()
        visible = int((n > 0).sum())
        ct = torch.randn((16, capacity), generator=g, device=dev)
        # kernel B can give -0.0 (a product with a zero weight); its gradient
        # is 0 outside every tile's range
        ct[torch.rand((16, capacity), generator=g, device=dev) < 0.01] = -0.0
        ct[:, live:] = 0.0
        args = (ct, slot, cum, counts)
        got = kernels.pack_vjp(*args)
        again = kernels.pack_vjp(*args)
        want = trc.pack_vjp_plain(*args)
        scan = scan_recipe(*args)
        torch.cuda.synchronize()
        same, stable = torch.equal(got, want), torch.equal(got, again)
        # ulps between the segment sums and the prefix difference
        ulps = (got.view(torch.int32).long() - scan.view(torch.int32).long()).abs()
        differ = int((ulps > 0).sum())
        moved = PACK_VJP_BYTES[0] * live + PACK_VJP_BYTES[1] * visible
        bound = 1e3 * moved / HBM_BYTES_S
        ms = cuda_ms(lambda: kernels.pack_vjp(*args), reps=50)
        plain_ms = cuda_ms(lambda: trc.pack_vjp_plain(*args), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: scan_recipe(*args), reps=10, warmup=1)
        prof = profile_calls(lambda: kernels.pack_vjp(*args), n=10)
        split = ("not measured (the profiler saw no device time)" if prof is None else
                 ", ".join(f"{k} {v:.4f} ms" for k, v, _ in prof[3] if "pack_vjp" in k))
        log(f"# pack_vjp, {name}: {P} rows, {visible} with instances, {live} instances of "
            f"{capacity} slots (largest segment {int(n.max())}, {int((n > 1000).sum())} over "
            f"1,000); kernel = plain bit for bit {same}, two launches bit-equal {stable}; "
            f"against the prefix difference {differ} of {got.numel()} elements differ, by at "
            f"most {int(ulps.max())} ulp")
        log(f"# pack_vjp, {name}: {ms:.4f} ms a view (CUDA events, 50 launches; limit "
            f"{PACK_VJP_MS_LIMIT[name]}), by kernel (profiler) {split}; bound {bound:.4f} ms "
            f"({moved / 1e6:.1f} MB at {HBM_BYTES_S / 1e12:.2f} TB/s), {100 * bound / ms:.1f}% "
            f"of it; plain {plain_ms:.4f} ms; the float64 scan {library_ms:.4f} ms; {card}")
        if not (same and stable):
            fail(f"pack_vjp at {name}'s shape is not its plain version bit for bit, or two "
                 f"launches differ")
        if ms < bound:
            fail(f"pack_vjp read {ms:.4f} ms at {name}'s shape, below its bound {bound:.4f} ms")
        if ms > PACK_VJP_MS_LIMIT[name]:
            fail(f"pack_vjp took {ms:.4f} ms a view at {name}'s shape, over "
                 f"{PACK_VJP_MS_LIMIT[name]} ms")
        out[name] = {"rows": P, "instances": live, "visible": visible, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                     "bytes": moved, "ulps_from_scan": int(ulps.max())}
        del ct, args, got, again, want, scan
    del views
    torch.cuda.empty_cache()
    return {"name": "pack_vjp", "route": "cuda", "source": "ex4dgs_tpu_torch/csrc/pack_vjp.cu",
            "replaces": None, "microbench_launches": kernels.launches["pack_vjp"],
            "max_abs_err": 0.0,
            **out["n3v_4dgs"], "bound_by": "bytes", "n3v": out["n3v"]}


def pack_vjp_alone() -> int:
    """Phase 19 alone (`python3 chip_smoke.py --only 19`): the kernels
    built, then the pack VJP kernel and its kernels line."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from ex4dgs_tpu_torch import kernels

    card = card_line()
    kernels.load_all()
    t0 = time.perf_counter()
    out = pack_vjp_phase(torch.device("cuda"), card)
    log(f"# phase 19 {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    # no main-path run in this mode: the full script counts them
    print(json.dumps({"kernels": [{**out, "launches": None}]}), flush=True)
    return 0


def pipeline_alone() -> int:
    """This slice's phases alone (`python3 chip_smoke.py --only 12`): the
    kernels built, phase 8 on the bench frame (the step's time, profile and
    host-read check), then phase 12 (the trainer path, pipelined and
    serial)."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from ex4dgs_tpu_torch import bench, kernels
    from ex4dgs_tpu_torch.bench_frame import bench_scene
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.train.step import StepStatics

    dev = torch.device("cuda")
    card = card_line()
    kernels.load_all()
    scene = bench_scene(dev)
    t0 = time.perf_counter()
    gt = torch.zeros((scene.cam.height, scene.cam.width, 3), device=dev)
    tick = bench.train_step_tick(scene, gt, None, dev)
    timing = bench.measure(tick, 20, 3, dev)
    log(f"# train step (bench.py recipe): {timing.ms:.3f} ms/iteration; windows "
        + ", ".join(f"{w:.3f}" for w in timing.windows_ms) + f" ms/iteration; {card}")
    report_profile("train step t=1", lambda: tick(1), card, timing.ms)
    statics = StepStatics(cfg=scene.cfg, opt=OptimizationConfig(), spatial_lr_scale=3.0,
                          capacity=scene.capacity)
    sync_check(dev, scene, gt, statics, card)
    log(f"# phase 8 {time.perf_counter() - t0:.1f} s")
    del scene, gt, tick
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out, _, _ = trainer_phase(dev, card, tmp)
        log(f"# phase 12 {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    import ex4dgs_tpu_torch  # noqa: F401  (sets the precision policy)
    from ex4dgs_tpu_torch import bench, kernels
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
    from ex4dgs_tpu_torch.train.step import StepStatics, clone_state, train_step

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
    report_profile("render t=1 track_idx=True", lambda: frame(1.0, True), card, fps[True])

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

    # train_step updates the state it is given in place: the phase trains
    # copies of the bench model and state, which later phases read
    step(*clone_state(model, state), 1.0)  # warm-up: allocator, caches
    torch.cuda.synchronize()
    train_launches = {name: 0 for name in kernels.launches}
    losses = []
    m, st = clone_state(model, state)
    for i in range(TRAIN_STEPS):
        kernels.reset_launches()
        out = step(m, st, float(i % 5))
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        for name, n in counts.items():
            train_launches[name] += n
        loss = out.loss.item()
        if counts != {**dict.fromkeys(counts, 0), "composite_fwd": 1, "composite_bwd": 1,
                      "pack_vjp": 1}:
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
    a = step(*clone_state(m, st), 1.0)
    b = step(*clone_state(m, st), 1.0)
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
    tick = bench.train_step_tick(scene, gt, None, dev)
    timing = bench.measure(tick, 20, 3, dev)
    train_ms = timing.ms
    log(f"# train step (bench.py recipe, ex4dgs_tpu_torch.bench.measure: 20 iterations, "
        f"best of 3 windows): {train_ms:.3f} ms/iteration, {W * H / train_ms / 1e3:.2f} "
        f"Mpix/s; windows " + ", ".join(f"{w:.3f}" for w in timing.windows_ms)
        + f" ms/iteration; {card}")
    torch.cuda.reset_peak_memory_stats()
    report_profile("train step t=1", lambda: tick(1), card, train_ms)
    sync_check(dev, scene, gt, statics, card)

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
    # phase 12's scene is trained on again by phase 16
    tmp12 = tempfile.TemporaryDirectory(prefix="ex4dgs_phase12_")
    trainer, model_dir, trained = trainer_phase(dev, card, tmp12.name)
    phase_done(12)
    evaluation = eval_phase(dev, model_dir, trained, fps, card)
    phase_done(13)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ex4dgs_phase14_") as tmp:
        quality = quality_phase(dev, card, tmp)
    phase_done(14)
    torch.cuda.empty_cache()
    cull = tight_cull_phase(dev, card)
    phase_done(15)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ex4dgs_phase16_") as tmp:
        multi = multi_gpu_phase(dev, {"composite_fwd": ms, "composite_bwd": ms_b}, train_ms,
                                os.path.join(tmp12.name, "scene"), card, tmp)
    tmp12.cleanup()
    phase_done(16)
    torch.cuda.empty_cache()
    benched = bench_phase(dev, card)
    phase_done(17)
    torch.cuda.empty_cache()
    slicing, pack_4d = slice4d_phase(dev, card)
    phase_done(18)
    torch.cuda.empty_cache()
    packing = pack_vjp_phase(dev, card)
    phase_done(19)
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
                     + evaluation["composite_fwd"]["surface_launches"]
                     + quality["composite_fwd"]["quality_launches"]
                     + cull["composite_fwd"]["tight_cull_launches"]
                     + multi["composite_fwd"]["multi_gpu_launches"]
                     + benched["composite_fwd"]["bench_launches"]),
        **trainer["composite_fwd"],
        **evaluation["composite_fwd"],
        **quality["composite_fwd"],
        **cull["composite_fwd"],
        "max_abs_err": err_fwd,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        **sub["composite_fwd"],
        **multi["composite_fwd"],
        **benched["composite_fwd"],
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "ex4dgs_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "ex4dgs_tpu/ops/rasterize_pallas.py:713",
        "launches": (train_launches["composite_bwd"] + sub["composite_bwd"]["subpixel_launches"]
                     + trainer["composite_bwd"]["trainer_launches"]
                     + evaluation["composite_bwd"]["viewer_launches"]
                     + quality["composite_bwd"]["quality_launches"]
                     + cull["composite_bwd"]["tight_cull_launches"]
                     + multi["composite_bwd"]["multi_gpu_launches"]
                     + benched["composite_bwd"]["bench_launches"]),
        **trainer["composite_bwd"],
        **evaluation["composite_bwd"],
        **quality["composite_bwd"],
        **cull["composite_bwd"],
        "max_abs_err": err_bwd,
        "ms": ms_b,
        "plain_ms": plain_ms_b,
        "bound_ms": bound_b,
        "bound_by": bound_by_b,
        "library_ms": None,
        **sub["composite_bwd"],
        **multi["composite_bwd"],
        **benched["composite_bwd"],
    }, *probe_entries, *slicing, {
        **packing,
        # one per train_step attempt on the main paths: train_step (6), the
        # trainer (12), the quality run (14), the tight cull (15) and
        # train_step_4d (18)
        "launches": (train_launches["pack_vjp"] + trainer["pack_vjp"]["trainer_launches"]
                     + quality["pack_vjp"]["quality_launches"]
                     + cull["pack_vjp"]["tight_cull_launches"] + pack_4d),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def multi_gpu_alone() -> int:
    """Phase 16 alone (`python3 chip_smoke.py --only 16`), with the inputs
    it takes from earlier phases made the same way: the kernels built,
    kernels A and B and train_step timed on the bench frame, phase 12's
    scene written. For comparing two trees' multi-GPU paths in one call."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from ex4dgs_tpu_torch import bench, kernels
    from ex4dgs_tpu_torch.bench_frame import (bench_scene, cotangents, cuda_ms, pack_frame,
                                              write_n3v_scene)

    dev = torch.device("cuda")
    card = card_line()
    kernels.load_all()
    scene = bench_scene(dev)
    f = pack_frame(scene)
    kw = dict(grid_x=f.grid_x, tile_x=32, tile_y=16, track_idx=True)
    acc, tf, _ = kernels.composite_fwd(f.data, f.gid, f.starts, f.stops, **kw)
    ms_a = cuda_ms(lambda: kernels.composite_fwd(f.data, f.gid, f.starts, f.stops, **kw), 20)
    bargs = (f.data, f.starts, f.stops, *cotangents(acc), tf)
    ms_b = cuda_ms(lambda: kernels.composite_bwd(*bargs, grid_x=f.grid_x, tile_x=32,
                                                 tile_y=16), 20)
    gt = torch.zeros((scene.cam.height, scene.cam.width, 3), device=dev)
    train_ms = bench.measure(bench.train_step_tick(scene, gt, None, dev), 20, 3, dev).ms
    log(f"# whole frame A {ms_a:.4f} ms, B {ms_b:.4f} ms, train_step {train_ms:.3f} "
        f"ms/iteration; {card}")
    del scene, f, acc, tf, bargs, gt
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "scene")
        write_n3v_scene(root, n_cams=4, n_frames=8, n_points=100_000, seed=0)
        t0 = time.perf_counter()
        out = multi_gpu_phase(dev, {"composite_fwd": ms_a, "composite_bwd": ms_b}, train_ms,
                              root, card, tmp)
        log(f"# phase 16 {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    only = {("--only", "12"): pipeline_alone, ("--only", "16"): multi_gpu_alone,
            ("--only", "17"): bench_alone, ("--only", "18"): slice4d_alone,
            ("--only", "19"): pack_vjp_alone}
    sys.exit(only.get(tuple(sys.argv[1:]), main)())
