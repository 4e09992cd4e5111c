"""Drive the PyTorch/CUDA port's entry points end to end on one NVIDIA GPU,
check what they give, and time every hand-written kernel.

    python3 chip_smoke.py
    python3 chip_smoke.py --only NAME [NAME ...]

`--only` runs the named phases, in the order below, with the phases they
need run before them (build always; `render` needs `scene`, `eval` needs
`trainer`). The kernels are held to their plain versions on every shape the
`cuda`-marked tests name (`python -m pytest --noconftest -m cuda
tests/test_torch_*.py`); this script runs the entry points at full width,
holds the kernels again on a trained model's view and on the cells' own
inputs, and prints one table of kernel times.

Phases (any failure ends the script with a non-zero exit and no result line):

build: compile every CUDA kernel from ex4dgs_tpu_torch/csrc/ with nvcc
   (sm_90a), one nvcc per source, all started together; print the build time
   and ptxas' register/shared-memory report.
scene: ex4dgs_tpu_torch.bench_frame.bench_scene, the bench scene of
   bench.py at full width (100k static + 10k dynamic splats, 1352x1014,
   scaling clamped to log(0.02)); the instance buffer is sized as bench.py
   sizes it (probe at 2M, then round_capacity(total * 5 // 4, 65536)).
render: rendering.render at t = 0, 1, 2.5, 4, 7.5 with track_idx True and
   False, then the FPS recipe of eval/render_sets.py (per-call host timing
   ending in torch.cuda.synchronize, warm-up calls dropped). The launch
   counters are set to 0 just before and read just after; the forward
   kernel must have launched once per render, every output must be finite,
   no frame may overflow its capacity and no image may be all background.
reference: a small scene rendered (also with the bench frame's subpixel
   offsets, and differentiated through that render), and trained one step,
   on the card and on the CPU (plain path) must agree.
trainer: a seeded on-disk N3V scene (bench_frame.write_n3v_scene: 4 cameras
   x 8 frames of 2704x2028 PNG, 100k points) is trained by the training CLI,
   `python -m ex4dgs_tpu_torch.train --config configs/N3V/n3v_base.json`
   (1352x1014 frames, every point) run as a user runs it (pipelined, the
   default), in a process of its own, with only the schedule shortened
   (TRAIN_SCHEDULE) so that 150 iterations cross every event kind that the
   schedule reaches before iteration 3000 (densify_and_prune,
   adjust_temp_opa, expand_duration, static->dynamic extraction), with a save
   and the test-set PSNR at 150; then it resumes from chkpnt150.npz for 10
   more iterations. The CLI sets the launch counters to 0 before training
   and reports them with everything else in its train_report.json. Every
   loss must be finite and the last 10 must average below the first 10;
   every scheduled event kind must have run; kernel A must have launched
   once per train_step (iterations plus overflow retries) and per test
   render, kernel B and the pack VJP once per train_step (the overflow gate
   is on the device: an overflowing attempt runs its backward too), nothing
   else; the PLY and the checkpoint must exist and push(load_checkpoint(...))
   on the card must pull back bit-equal to the trainer's pull at save
   (sha256 of every array); kernels A and B on the saved model's view of
   the middle train camera, at the trainer's capacity and tile, held to
   their plain versions as the kernels phase holds them (B within
   HARD_FRAME_RATIO times the plain version's own spread where that misses
   the limit against itself). Printed: ms/iteration by the host clock (whole
   loop, and without the event iterations), each event's time, pull and
   push times, n_static/n_dynamic after each event, the GT cache's decoder
   (the native libpng pool, or PIL where it does not build), hits and bytes;
   the events the schedule does not reach before iteration 3000
   (prune_invisible, prune_small) or at all (prune_nan, reset_opacity) are
   timed on the saved model. The loop pipelined against serial
   (EX4DGS_PIPELINE=0) at full width in this process, on the CLI run's
   config and scene at its final capacity, over the iterations before its
   first event, in turns (pipelined, serial, serial, pipelined): losses and
   final models bit-equal, no overflow, both ms/iteration printed. Last, the
   trainer on a tiny scene on the card and on the CPU for the 20 iterations
   before its first event (losses within rtol 1e-5, the same cameras and
   backgrounds), and a forced overflow on the card and on the CPU (capacity
   256: one more launch of kernels A and B per retry, the same first loss,
   and the pipelined loop's swap, each overflowed step re-run after the step
   dispatched behind it, in the same order on both).
eval: the render CLI, `python -m ex4dgs_tpu_torch.render_cli --model_path
   <the trainer phase's model> --iteration 150 --fps_inner 100`, in a
   process of its own, on both splits at 1352x1014, with
   EX4DGS_LPIPS_WEIGHTS naming seeded random AlexNet/VGG weights written
   here (their values are labelled "seeded random weights, not LPIPS"): each
   split's frame count is the scene's sampled camera count, every metric is
   finite, mean_metrics.json carries the reference's keys, kernel A launched
   what the recipe implies (each metric frame and overflow retry; on the
   test split also the probe render, 20 x 100 FPS calls and one round of 100
   at the training-sized capacity), and the test PSNR equals the trainer's
   at 150 within 1e-3 dB where the frame sets are the same. Printed: the FPS
   recipe's ms/frame, FPS and Mpix/s beside the render phase's, the host ms
   per frame of each metric. Then LPIPS (alex, vgg) of one rendered frame on
   the card against the CPU within rtol 1e-4, atol 1e-6, with TF32 off;
   viewer requests for one test camera at 1352x1014 (3 timestamps and a
   keep-alive) over loopback, each reply bit-equal to the converted
   render(..., track_idx=False) of its camera, one launch of kernel A per
   non-empty request; the tiny scene's Trainer serving one request during 3
   iterations; and the quality probe's surface scene (50k + 5k splats, seed
   7) from its 19-camera rig at 800x600, t = 0 and 4: finite, visible,
   moving, one launch per render, one camera equal to the CPU's plain render
   within 3e-5. (The tiny scene's trainer decodes with PIL there, as
   render_set does: its default native pool box-filters the resampled
   frames.)
quality: `python -m ex4dgs_tpu_torch.quality`'s `run` at its defaults, the
   port of tools/tpu_probes/_tpu_quality2.py: the surface scene (50k + 5k
   splats, seed 7) from the 19-camera rig at 800x600, its 152 ground-truth
   frames rendered here, the full schedule, 3000 iterations, camera 0 held
   out. Printed beside the JAX package's anchors (BASELINE.md, strict dots:
   33.53 dB, SSIM 0.978, the per-timestamp PSNRs, 31.2 dB at 250 and 33.85
   at 2500, 52.6k static and 5.9k dynamic): the SUMMARY, the PSNR per
   timestamp, the trajectory, the final cloud, the wall time, the host-clock
   ms per iteration with and without the event iterations, and the render
   FPS at the snug capacity. It fails on a held-out PSNR below 32.53 dB
   (33.53 less BASELINE.md's +-1 dB trajectory noise), an SSIM below 0.968,
   a non-finite loss, or kernel launches other than the run implies (A:
   ground truth, steps with their overflow retries, test renders, 8
   held-out renders, 1 probe and 550 FPS renders; B and the pack VJP: one
   per train_step, overflow retries included), or kernels A and B on the
   trained model's view disagreeing with their plain versions (as in the
   trainer phase).
multi_gpu (on the one card): (1) the bench frame at t = 1 with its tile rows
   in 2 and 4 slabs, run in turn in this process through
   rendering.composite_projected_slabs at a capacity sized from the worst
   slab (slabs x its total + 25%, bucketed): render, depth, flow, acc and
   dominant index bit-equal to the unsharded frame, one launch of kernel A
   per slab with the counters set to 0 before and read after. (2)
   torch.distributed on NCCL with one rank: the sharded step at mesh (1, 1)
   from the bench state bit-equal (digest) to train_step's, two steps from
   one state bit-equal, one launch of A, B and the pack VJP a step, timed by
   bench.py's recipe beside train_step timed so in the same process. (3) Two
   spawned ranks on the card over gloo (NCCL refuses two ranks on one
   device), meshes (1, 2) and (2, 1) on the bench state: each within
   tests/test_parallel.py's tolerances of train_step (loss rtol 1e-4; per
   parameter 95% within rtol 2e-4 / atol 5e-5 and max |diff| < 2e-3; denom x
   data), the ranks' models digest-equal, no overflow, one launch of A, B
   and the pack VJP per rank a step; ms per step. (4) The training CLI as
   two ranks (--mesh_data 2 --coordinator --num_processes --process_id
   --dist_backend gloo) on the trainer phase's scene (written here if that
   phase did not run) for 40 iterations of its schedule (densify_and_prune
   at 30): the ranks' final checkpoints digest-equal, finite falling losses,
   kernel launches as the schedule implies, ms/iteration. Every spawned rank
   has a time limit and is killed on failure.
bench: `python -m ex4dgs_tpu_torch.bench` in a subprocess at its default
   sizes (bench.py's scene and recipe), then again with EX4DGS_TILE=16x16
   EX4DGS_EXACT_SORT=1 and 2 iterations in one window, each under a time
   limit. Its last line must hold bench.py's keys in order, finite positive
   rates and times, instances within the capacity, one launch of kernels A
   and B per fwd+bwd call and per train step and one of A (none of B) per
   render, the kernel config asked for (32x16 with the packed key, then
   16x16 with the exact sort, whose instances must outnumber the first
   run's) and a `card` naming the card. Both lines are printed.
fourdgs: train_step_4d, the n3v_4dgs cell's path, three times at the
   cell's shape (gsbench/configs/n3v_4dgs.json: its model as gsbench draws
   it, 500,000 4D Gaussians in 503,808 rows, its statics, 4 views of
   1352x1014 a step at 16x16 tiles with the exact sort), the views, times
   and background changing: an eager call, a capture with its replay, a
   replay. The launch and graph counters are set to 0 just before; the
   slicing kernels and the pack VJP must launch once per view (12 each),
   the graph calls must be 1 eager, 1 capture and 2 replays, and every loss
   finite, with no NaN and no overflow.
kernels: every hand-written kernel (kernels.SOURCES) held to its plain
   version on the card, then both timed: A, B and the pack VJP V on the
   bench frame at t = 1 (32x16 tiles, the packed key, seeded cotangents),
   V also on the n3v_4dgs cell's binning (V4: its model through one view at
   16x16 tiles with the exact sort, 4,063,232 slots), the probes P1 and
   P2a-e at their own sizes, the slicing pair S1 and S2 on the n3v_4dgs
   cell's model (SH degree 3 x time degree 2). Each kernel is launched
   twice (bit-equal) and held to its plain version as the `cuda` tests hold
   it: A (hold_a) within 2e-5 and TF_RTOL, B (hold_b) within
   BWD_RTOL/BWD_ATOL and bit-equal to its twin, S1 and S2 within SLICE_RTOL
   and SLICE_BWD_RTOL, the probes and V bit for bit. A, B, S1, S2 and V are
   timed by bench_frame.cuda_ms (CUDA events over back-to-back launches, so
   inputs that fit in L2 are read from it), the probes as
   probes.readings_ms times them (one launch after an L2 flush, the
   median). One JSON object holds a row per kernel and shape, with its
   largest difference from plain.

The last lines are the card's name and power limit (as nvidia-smi prints
them), the kernels phase's object, and {"ok": true, "device": {...}}.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
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


def rel_err(a, b) -> float:
    """Largest |a - b| over the largest |b| (the difference itself where b
    is all 0)."""
    diff = float((a.double() - b.double()).abs().max())
    den = float(b.double().abs().max())
    return diff / den if den > 0 else diff


def held(what: str, got, again, want, rtol: float = 0.0, flips: int = 0) -> float:
    """A kernel's outputs `got` (a tensor or a tuple of them; `again`, a
    second launch's) against its plain version's `want`: the two launches
    bit-equal, each float output bit for bit (rtol 0) or within rtol of its
    largest |want|, each boolean one differing in at most `flips` elements.
    Fails otherwise; returns the largest relative difference."""
    got, again, want = (x if isinstance(x, (tuple, list)) else (x,) for x in (got, again, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    floats = [(a, w) for a, w in zip(got, want) if a.dtype != torch.bool]
    exact = all(torch.equal(a, w) for a, w in floats)
    rel = 0.0 if exact else max(rel_err(a, w) for a, w in floats)
    flipped = sum(int((a != w).sum()) for a, w in zip(got, want) if a.dtype == torch.bool)
    log(f"# {what} vs plain: {'bit for bit' if exact else f'{rel:.3g} of the largest'} "
        f"(rtol {rtol:g}), {flipped} boolean flips (<= {flips}), two launches bit-equal {same}")
    if not (same and flipped <= flips and (exact or (rtol > 0 and rel <= rtol))):
        fail(f"{what}: the kernel disagrees with its plain version")
    return rel


def hold_a(what: str, got, again, want) -> float:
    """Kernel A's outputs `got` (and a second launch's, `again`) against its
    plain version's `want`, as tests/test_torch_composite.py holds them:
    accum and tfinal within 2e-5, tfinal within TF_RTOL of itself off the
    latch, the dominant ids equal on >= 99.9% of pixels, finite, two
    launches bit-equal. Fails otherwise; returns the largest accum or
    tfinal difference."""
    from ex4dgs_tpu_torch.ops.rasterize_cuda import TF_RTOL, tfinal_rel_err

    err = max((a - w).abs().max().item() for a, w in zip(got[:2], want[:2]))
    rel, _ = tfinal_rel_err(got[1], want[1])
    agree = (got[2] == want[2]).float().mean().item()
    finite = all(bool(torch.isfinite(x).all()) for x in got[:2])
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"# {what}: composite_fwd vs plain: accum, tfinal {err:.3g} (atol 2e-5), tfinal "
        f"{rel:.3g} of itself off the latch (rtol {TF_RTOL:g}), ids equal on {agree:.6f} "
        f"(>= 0.999), finite {finite}, two launches bit-equal {same}")
    if not (err <= 2e-5 and rel <= TF_RTOL and agree >= 0.999 and finite and same):
        fail(f"{what}: kernel A disagrees with its plain version")
    return err


def hold_b(what: str, got, again, want, args: tuple, kw: dict, trained: bool = False) -> float:
    """Kernel B's dgrad `got` (and a second launch's, `again`) on `args`,
    as tests/test_torch_backward.py holds it: finite, zero outside every
    tile's range, two launches bit-equal, bit-equal to its twin
    composite_tiles_bwd_walk, and each row group within BWD_RTOL/BWD_ATOL
    of the plain version's `want`. On a `trained` model's view a row group where the
    plain version walked one instance at a time misses that limit against
    itself (near-singular conics) may reach HARD_FRAME_RATIO times that
    spread. Fails otherwise; returns the largest difference from plain."""
    from ex4dgs_tpu_torch.ops import rasterize_cuda as trc

    lo, hi = int(args[1][0]), int(args[2][-1])
    errs = trc.bwd_errors(got, want, lo, hi)
    limit = dict.fromkeys(errs, 1.0)
    if trained and any(e[1] > 1.0 for e in errs.values()):
        spread = trc.bwd_errors(trc.composite_tiles_bwd_plain(*args, chunk=1, **kw), want,
                                lo, hi)
        limit = {k: max(1.0, trc.HARD_FRAME_RATIO * spread[k][1]) for k in errs}
    twin = torch.equal(got, trc.composite_tiles_bwd_walk(*args, **kw))
    same = torch.equal(got, again)
    finite = bool(torch.isfinite(got).all())
    outside = not (got[:, :lo].any() or got[:, hi:].any() or got[14:].any())
    log(f"# {what}: composite_bwd vs plain, worst err/limit: " + ", ".join(
        f"{k} {e[1]:.3g} (<= {limit[k]:.3g})" for k, e in errs.items())
        + f"; bit-equal to its twin {twin}, two launches bit-equal {same}, finite {finite}, "
        f"zero outside the ranges {outside}")
    if not (twin and same and finite and outside
            and all(e[1] <= limit[k] for k, e in errs.items())):
        fail(f"{what}: kernel B disagrees with its plain version or its twin")
    return max(e[0] for e in errs.values())


def render_phase(dev, scene, card: str) -> dict:
    """The render phase (see the module's docstring). Returns the FPS
    recipe's ms per frame by track_idx."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import H, W
    from ex4dgs_tpu_torch.rendering import render

    model, cfg, cam, _, capacity = scene
    bg = torch.zeros(3, device=dev)

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
    return fps


def reference_phase() -> None:
    """The reference phase: a small scene rendered (without and with the
    bench frame's subpixel offsets, and differentiated with them), and
    trained one step, on the card and on the CPU."""
    from ex4dgs_tpu_torch.bench_frame import bench_offsets
    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.models.optimizer import init_state
    from ex4dgs_tpu_torch.rendering import render
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
    from ex4dgs_tpu_torch.train.step import StepStatics, train_step

    small, sub, sub_grads, small_train = {}, {}, {}, {}
    gt_small = torch.as_tensor(np.random.default_rng(0).uniform(size=(96, 160, 3))
                               .astype(np.float32))
    off_small = bench_offsets("cpu")[:96, :160].contiguous()
    for d in ("cuda", "cpu"):
        m_s, c_s = make_scene(n_static=3000, n_dynamic=300, duration=10.0, seed=1, device=d)
        cam_s = ring_cameras(1, 3.0, 160, 96, far=c_s.far, device=d)[0]
        bg_s = torch.tensor([0.1, 0.2, 0.3]).to(d)
        small[d] = render(cam_s, m_s, c_s, t=2.5, bg=bg_s, capacity=65536, device=d)
        leaves = {k: v.detach().requires_grad_(True) for k, v in m_s.params.items()}
        sub[d] = render(cam_s, m_s.replace(params=leaves), c_s, t=2.5, bg=bg_s, capacity=65536,
                        subpixel_offset=off_small.to(d), device=d)
        (sub[d].render - 0.5).abs().mean().backward()
        sub_grads[d] = {k: v.grad.cpu() for k, v in leaves.items() if v.grad is not None}
        st_s = StepStatics(cfg=c_s, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                           capacity=65536)
        small_train[d] = train_step(m_s, init_state(m_s.params, device=d), cam_s,
                                    gt_small.to(d), 2.5, bg_s, 100, st_s, device=d)
    for what, res in (("", small), (" with subpixel offsets", sub)):
        g, c = res["cuda"], res["cpu"]
        err_small = (g.render.detach().cpu() - c.render.detach()).abs().max().item()
        err_small_acc = (g.acc.cpu() - c.acc).abs().max().item()
        agree_small = (g.dominent_idxs.cpu() == c.dominent_idxs).float().mean().item()
        log(f"# small scene 160x96{what}, cuda vs cpu: color {err_small:.3g}, acc "
            f"{err_small_acc:.3g} (atol 1e-4), idx agreement {agree_small:.5f} (>= 0.99), "
            f"instances {int(g.binning_total)} vs {int(c.binning_total)}")
        if not (err_small <= 1e-4 and err_small_acc <= 1e-4 and agree_small >= 0.99):
            fail(f"the card's render of the small scene{what} disagrees with the CPU's")
    grad_rel = max((sub_grads["cuda"][k] - v).abs().max().item() / v.abs().max().item()
                   for k, v in sub_grads["cpu"].items() if v.abs().max().item() > 0)
    log(f"# small scene with subpixel offsets, cuda vs cpu: gradients {grad_rel:.3g} of their "
        f"largest (<= 1e-3)")
    if not grad_rel <= 1e-3:
        fail("the card's gradients through a render with subpixel offsets disagree with the CPU's")
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


# The trainer phase: the N3V config with only the schedule shortened, so that
# 150 iterations cross every event kind the schedule reaches before
# iteration 3000 (tests/test_trainer.py's schedule); resolution and point
# count uncut.
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


def run_cli(args: list, timeout: int) -> dict:
    """python -m ex4dgs_tpu_torch.train with `args`, from the repo root, as
    a user runs it; returns its train_report.json."""
    model_path = args[args.index("--model_path") + 1]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ex4dgs_tpu_torch.train", *args], cwd=ROOT,
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


def trainer_kernels_hold(dev, model, cfg, capacity: int, cam, what: str) -> None:
    """Kernels A and B on a trained model's view: `model` seen by the data
    Camera `cam` at its timestamp, packed into the trainer's `capacity` at
    the trainer's tile, held to their plain versions by hold_a and hold_b
    (B on seeded cotangents)."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import cotangents, pack_view
    from ex4dgs_tpu_torch.kernel_config import KernelConfig
    from ex4dgs_tpu_torch.ops.rasterize_cuda import (composite_tiles_bwd_plain,
                                                     composite_tiles_plain)

    kcfg = KernelConfig()
    tx, ty = kcfg.tile_x, kcfg.tile_y
    data, gid, starts, stops, gx, n_points = pack_view(
        model, cfg, cam.render_camera(dev), cam.timestamp, capacity, tx, ty)
    what = (f"{what}, {cam.image_name} at t={cam.timestamp:g} ({cam.width}x{cam.height}, "
            f"{n_points} rows, {int(stops[-1] - starts[0])} instances in {capacity}, tile "
            f"{tx}x{ty})")
    args, kw = (data, gid, starts, stops), dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True)
    got = kernels.composite_fwd(*args, **kw)
    hold_a(what, got, kernels.composite_fwd(*args, **kw), composite_tiles_plain(*args, **kw))
    bargs, bkw = (data, starts, stops, *cotangents(got[0]), got[1]), dict(grid_x=gx, tile_x=tx,
                                                                           tile_y=ty)
    hold_b(what, kernels.composite_bwd(*bargs, **bkw), kernels.composite_bwd(*bargs, **bkw),
           composite_tiles_bwd_plain(*bargs, **bkw), bargs, bkw, trained=True)


def trainer_phase(dev, card: str, tmp: str) -> tuple[str, dict]:
    """The trainer phase: the training entry point at full width through a
    whole (shortened) schedule, a resume, kernels A and B on the saved
    model's view (trainer_kernels_hold), the events the schedule does not
    reach, and the trainer on a tiny scene on the card against the CPU. The
    scene and the model go to `tmp`. Returns the model directory and the
    first run's train_report.json."""
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
    from ex4dgs_tpu_torch.data.scene import Scene
    from ex4dgs_tpu_torch.io.checkpoint import digest, load_checkpoint
    from ex4dgs_tpu_torch.models import density as D
    from ex4dgs_tpu_torch.models.config import ModelConfig, overlay_json

    config = os.path.join(ROOT, "configs", "N3V", "n3v_base.json")
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
                    900)
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
    cams = Scene(cfg).train_cameras
    trainer_kernels_hold(dev, model, cfg, first["capacity"], cams[len(cams) // 2],
                         "trainer path, saved model")

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
                              "--start_checkpoint", ckpt], 600)
    trainer_report_lines("trainer path, resumed", resumed, card)
    if (resumed["iterations"] != [TRAIN_ITERS + 1, TRAIN_ITERS + RESUME_ITERS]
            or not np.isfinite(resumed["loss"]).all()):
        fail(f"trainer path: the resumed run took iterations {resumed['iterations']}, "
             f"losses finite {np.isfinite(resumed['loss']).all()}")
    check_launches("trainer path, resumed", resumed)
    small_trainer_check(dev, card)
    return out, first


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


def small_trainer_check(dev, card: str) -> None:
    """The trainer on a tiny on-disk scene (the CPU tests' size) on the
    card and on the CPU, for the 20 iterations before its first event:
    losses within rtol 1e-5 (tests/test_torch_train.py's step tolerance,
    the reference phase's for the loss of one step on the card against
    the CPU).
    Then the card's run on through its 120-iteration schedule, where the
    cloud outgrows its static capacity (the growth branch of the capacity
    policy, which the full-width run does not reach), and a forced
    overflow on the card and on the CPU (starting capacity 256): the same
    first loss as the run that never overflowed, one more launch of
    kernels A and B per retry, and the pipelined loop's swap (each
    overflowed step re-run after the step dispatched behind it) in the same
    order of (iteration, timestamp) on both."""
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


# The eval phase: the eval and viewer paths on the trainer phase's model
# and on the surface scene of tools/tpu_probes/_tpu_quality2.py (800x600,
# 19 cameras).
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


def eval_cli_check(model_dir: str, trained: dict, scene, fps_render: dict | None,
                   weights_dir: str, card: str) -> None:
    """The render CLI on the trainer phase's model, both splits at full
    width, with the seeded random LPIPS weights; `fps_render` is the render
    phase's FPS recipe (None where it did not run)."""
    env = {**os.environ, "EX4DGS_LPIPS_WEIGHTS": weights_dir}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ex4dgs_tpu_torch.render_cli", "--model_path",
                          model_dir, "--iteration", str(EVAL_ITERATION), "--fps_inner",
                          str(EVAL_FPS_INNER)], cwd=ROOT, env=env, capture_output=True,
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
                f"{tm['capacity']}: {tm['fps_ms_at_capacity']:.3f} ms/frame; the render "
                f"phase's FPS recipe on the bench scene (ms/frame by track_idx): "
                f"{fps_render or 'not run'}; the CLI took {wall:.1f} s; {card}")
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


def lpips_card_check(dev, img, gt, card: str) -> None:
    """LPIPS of one rendered frame on the card and on the CPU, with the
    seeded random weights (EX4DGS_LPIPS_WEIGHTS set by the caller)."""
    from ex4dgs_tpu_torch.eval.lpips import LPIPS

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
        log(f"# LPIPS {net} on one {tuple(img.shape)} frame (seeded random weights, not "
            f"LPIPS): card {g!r} in {g_ms:.1f} ms, CPU {c!r} in {c_ms:.0f} ms; |diff| "
            f"{abs(g - c):.3g} (rtol {LPIPS_RTOL:g}, atol {LPIPS_ATOL:g}); cudnn.allow_tf32 "
            f"{torch.backends.cudnn.allow_tf32}; {card}")
        if not abs(g - c) <= LPIPS_ATOL + LPIPS_RTOL * abs(c):
            fail(f"LPIPS {net} on the card disagrees with the CPU")


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


def viewer_check(dev, model, cfg, scene, capacity: int, card: str) -> None:
    """Viewer requests for one test camera at full width, served from
    the loaded model, each reply the converted render of its camera bit for
    bit; then the tiny scene's Trainer serving a request on the card, and
    `render_set` on its model giving its test report's PSNR (no event
    runs, so the model is the one the report rendered; the trainer decodes
    its frames with PIL, as render_set does, not with its default native
    pool, which box-filters the resampled frames)."""
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


def surface_check(dev, card: str) -> None:
    """The quality probe's surface scene and rig
    (tools/tpu_probes/_tpu_quality2.py:52-57) rendered on the card at
    t = 0 and 4 from every camera; one camera against the CPU's plain
    render."""
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
            i0 = frame(c, 0.0)
            # the next render of the same key overwrites a replayed result
            i0 = i0._replace(render=i0.render.clone(), binning_total=i0.binning_total.clone())
            i4 = frame(c, 4.0)
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


def eval_phase(dev, model_dir: str, trained: dict, fps_render: dict | None, card: str) -> None:
    """The eval phase: the render CLI, LPIPS on the card against the CPU,
    the viewer, and the surface scene."""
    from ex4dgs_tpu_torch.data.scene import load_image
    from ex4dgs_tpu_torch.rendering import render

    model, cfg, scene = load_trained(dev, model_dir, EVAL_ITERATION)
    with tempfile.TemporaryDirectory(prefix="ex4dgs_lpips_") as wdir:
        for i, net in enumerate(("alex", "vgg")):
            np.savez(os.path.join(wdir, f"lpips_{net}.npz"), **lpips_random_weights(net, 100 + i))
        eval_cli_check(model_dir, trained, scene, fps_render, wdir, card)
        cam = scene.sampled_test_cameras()[0]
        with torch.no_grad():
            img = render(cam.render_camera(dev), model, cfg, t=cam.timestamp,
                         bg=torch.zeros(3, device=dev), capacity=trained["capacity"],
                         device=dev).render.clamp(0, 1)
        gt = torch.from_numpy(load_image(cam.image_path, (cam.width, cam.height),
                                         cam.im_scale)).to(dev)
        os.environ["EX4DGS_LPIPS_WEIGHTS"] = wdir
        try:
            lpips_card_check(dev, img, gt, card)
        finally:
            del os.environ["EX4DGS_LPIPS_WEIGHTS"]
    viewer_check(dev, model, cfg, scene, trained["capacity"], card)
    del model
    torch.cuda.empty_cache()
    surface_check(dev, card)


# The quality phase: the quality run (tools/tpu_probes/_tpu_quality2.py) at
# full width through python -m ex4dgs_tpu_torch.quality's `run`, and the JAX
# package's anchors on the TPU (BASELINE.md "surface, 19 cams, 3000 iters",
# strict dots): held-out PSNR and SSIM, per timestamp, the trajectory and
# the final cloud. These are quality figures; no TPU time is compared.
JAX_PSNR, JAX_SSIM, PSNR_NOISE = 33.53, 0.978, 1.0
JAX_PSNR_BY_T = (34.4, 35.1, 35.2, 35.1, 34.9, 33.5, 31.2, 28.9)
JAX_TRAJECTORY = {250: 31.2, 2500: 33.85}
JAX_N_STATIC, JAX_N_DYNAMIC = 52_600, 5_900
SSIM_FLOOR = JAX_SSIM - 0.01


def quality_phase(dev, card: str, tmp: str) -> None:
    """The quality phase: the surface scene at 800x600 from the 19-camera
    rig, the full schedule, 3000 iterations (quality.run with its defaults).
    Fails
    on a held-out PSNR below JAX's anchor less the trajectory noise, an
    SSIM below JAX's less 0.01, a non-finite loss, or kernel launches other
    than the run implies: kernel A once per ground-truth render (19 x 8),
    per train_step call (iterations and overflow retries), per test render,
    per held-out render (8), for the probe and for each of the 50 + 500 FPS
    renders; kernel B once per train_step call as well (an attempt that
    overflows its capacity runs its backward, gated on the device, and is
    re-run), and the pack VJP with it. Then kernels A and B on the trained
    model's view (trainer_kernels_hold)."""
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
    trainer_kernels_hold(dev, tr.model, out["cfg"], tr.capacity, cams[len(cams) // 2],
                         "quality run, trained model")


# The multi_gpu phase: the slab counts of the in-process slab check, the
# meshes of the two gloo ranks on the one card, and the 2-rank trainer CLI's
# schedule (TRAIN_SCHEDULE's: densify_and_prune at 30).
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


def slab_phase(dev, scene) -> dict:
    """The bench frame's tile rows in 2 and 4 slabs, run in turn in this
    process. Returns the sharded capacities by slab count."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.rendering import (composite_projected, composite_projected_slabs,
                                            preprocess_points)

    model, cfg, cam, _total, capacity = scene
    bg = torch.zeros(3, device=dev)
    gx, gy = tile_grid(cam.width, cam.height)
    fields = ("render", "depth", "opticalflow", "acc", "dominent_idxs")
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
    return caps


def nccl_one_phase(dev, scene, card: str) -> float:
    """The sharded step on a world of one rank over NCCL, at mesh (1, 1),
    against train_step, and both timed by bench.py's recipe. Returns
    train_step's ms per iteration."""
    import torch.distributed as dist

    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench import measure, train_step_tick
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
        train_ms = measure(train_step_tick(scene, gt, None, dev), 20, 3, dev).ms
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    log(f"# sharded step, world 1 over {backend} ({info}), mesh (1, 1): bit-equal to "
        f"train_step {d_a == d_ref}, two steps from one state bit-equal {d_a == d_b}; loss "
        f"{a.loss.item():.6f} (train_step {ref.loss.item():.6f}); launches {launches}; "
        f"{timing.ms:.3f} ms/iteration by bench.py's recipe (windows "
        + ", ".join(f"{w:.3f}" for w in timing.windows_ms)
        + f") against train_step's {train_ms:.3f}; {card}")
    if backend != ("nccl" if dev.type == "cuda" else "gloo") or d_a != d_ref or d_a != d_b:
        fail("the NCCL (1, 1) sharded step is not train_step's, or not deterministic")
    if launches != {**dict.fromkeys(launches, 0), "composite_fwd": 2, "composite_bwd": 2,
                    "pack_vjp": 2}:
        fail(f"the (1, 1) sharded step launched {launches}, expected one A, one B and one pack "
             f"VJP a step")
    return train_ms


def _gloo_rank(rank: int, port: int, caps: dict, out_dir: str, device: str,
               scene_fn) -> None:
    """One of two ranks on the one card over gloo: the state of
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
                   tmp: str) -> None:
    """Two ranks on the one card over gloo, at meshes (1, 2) and (2, 1),
    each held to train_step from the same state at tests/test_parallel.py's
    tolerances and its gradient (the first step's mu) at
    tests/test_torch_train.py's moment tolerance."""
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
            f"{train_ms:.3f}; {card}")
        if not (ok and loss_ok and denom_ok and same and launch_ok):
            fail(f"the gloo sharded step at mesh {mesh} disagrees with train_step")
        if any(x["total"] > x["capacity"] or x["nan"] for x in outs):
            fail(f"the gloo sharded step at mesh {mesh} overflowed or raised the NaN flag")
    log(f"# gloo phase: {wall:.1f} s for both ranks (start-up, bench scene, both meshes)")


def cli_two_phase(dev, scene_dir: str, card: str, tmp: str) -> None:
    """The training CLI as two ranks on the one card over gloo,
    --mesh_data 2, on the N3V scene in scene_dir for CLI16_ITERS
    iterations."""
    config = os.path.join(ROOT, "configs", "N3V", "n3v_base.json")
    out = os.path.join(tmp, "model16")
    port = free_port()
    base = [sys.executable, "-m", "ex4dgs_tpu_torch.train", "--config", config,
            "--source_path", scene_dir, "--model_path", out, "--quiet", *TRAIN_SCHEDULE,
            "--iterations", str(CLI16_ITERS), "--mesh_data", "2", "--mesh_gauss", "1",
            "--coordinator", f"localhost:{port}", "--num_processes", "2",
            "--dist_backend", "gloo", *(["--device", "cpu"] if dev.type == "cpu" else [])]
    logs = [open(os.path.join(tmp, f"cli16_rank{r}.log"), "w+") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(base + ["--process_id", str(r)], cwd=ROOT, stdout=logs[r],
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


def multi_gpu_phase(dev, scene_dir: str, card: str, tmp: str, scene_fn=None) -> None:
    """The multi_gpu phase: slabs in one process, NCCL world 1, two gloo
    ranks on the card, the 2-rank trainer CLI, on scene_fn's scene (default
    the bench scene) and the N3V scene in scene_dir."""
    from ex4dgs_tpu_torch.bench_frame import bench_scene

    scene_fn = scene_fn or bench_scene
    scene = scene_fn(dev)
    t = [time.perf_counter()]

    def mark():
        t.append(time.perf_counter())
        return t[-1] - t[-2]

    caps = slab_phase(dev, scene)
    s1 = mark()
    train_ms = nccl_one_phase(dev, scene, card)
    s2 = mark()
    gloo_two_phase(dev, scene, scene_fn, caps, train_ms, card, tmp)
    s3 = mark()
    del scene
    torch.cuda.empty_cache()
    cli_two_phase(dev, scene_dir, card, tmp)
    s4 = mark()
    log(f"# multi_gpu parts (s): slabs {s1:.1f}, NCCL world 1 {s2:.1f}, gloo 2 ranks "
        f"{s3:.1f}, 2-rank CLI {s4:.1f}")


# The bench phase: the bench entry point, as a user runs it.
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
    rates and times, instances within the capacity, the launches per call
    of BENCH_LAUNCHES, and a card that names this one."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ex4dgs_tpu_torch.bench"], cwd=ROOT,
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
               "render_noidx_ms", "composite_fwd_ms", "composite_bwd_ms")
    bad = [k for k in numbers if not (isinstance(got[k], float) and math.isfinite(got[k])
                                      and got[k] > 0)]
    if bad:
        fail(f"the bench's {bad} not finite and positive")
    if not 0 < got["instances"] <= got["capacity"]:
        fail(f"the bench's {got['instances']} instances and capacity {got['capacity']}")
    per_call = {k: got["launches"][k] for k in BENCH_LAUNCHES}
    if per_call != BENCH_LAUNCHES:
        fail(f"the bench's launches per call {per_call}, expected {BENCH_LAUNCHES}")
    if got["card"] != card:
        fail(f"the bench names the card {got['card']!r}, nvidia-smi {card!r}")
    return got


def bench_phase(card: str) -> None:
    """The bench phase: the bench entry point at its defaults, then at 16x16
    with the exact sort."""
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


def load_cell(name: str) -> dict:
    """A cell's configuration, gsbench/configs/<name>.json."""
    with open(os.path.join(ROOT, "gsbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def fourdgs_phase(dev, card: str) -> None:
    """The fourdgs phase (see the module's docstring)."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.synthetic import ring_cameras
    from ex4dgs_tpu_torch.runtime import graphs
    from gsbench.families import fourdgs

    cell = load_cell("n3v_4dgs")
    prog = fourdgs.Program(cell, dev)
    carried = prog.start(prog.model(fourdgs.make_params(cell, 18, dev)))
    w, h, n = cell["width"], cell["height"], fourdgs.VIEWS_PER_STEP
    cams = ring_cameras(8, 12.0, w, h, device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    gts = [torch.rand((h, w, 3), generator=g, device=dev) for _ in range(n)]
    graphs.release()
    kernels.reset_launches()
    kernels.reset_graph_calls()
    outs = []
    for i in range(3):  # an eager call, a capture with its replay, a replay
        views = [cams[(2 * i + j) % len(cams)] for j in range(n)]
        t0 = time.perf_counter()
        loss, total, nan = prog.step(carried, views, gts, [27 + 69 * j + 12 * i for j in range(n)],
                                     torch.rand(3, generator=g, device=dev), 10_000 + i)
        torch.cuda.synchronize()
        outs.append((float(loss), bool(nan), int(total), (time.perf_counter() - t0) * 1e3))
    calls = kernels.graph_call_counts(dev)
    launched = {k: kernels.launches[k] for k in ("slice4d_fwd", "slice4d_bwd", "pack_vjp")}
    capacity = carried["statics"].capacity
    graphs.release()
    log(f"# train_step_4d x3 at {w}x{h}, {n} views, the n3v_4dgs cell's model (loss, nan, "
        f"largest view's instances of {capacity}, host ms): {outs}; graph calls {calls}; "
        f"launches {launched}; {card}")
    if calls != {"eager": 1, "captures": 1, "replays": 2}:
        fail(f"train_step_4d's graph calls are {calls}, not an eager call, a capture and two "
             f"replays")
    if launched != dict.fromkeys(launched, 3 * n):
        fail(f"the slicing kernels and the pack VJP launched {launched} times in 3 steps of {n} "
             f"views")
    if any(nan or not math.isfinite(loss) or tot > capacity for loss, nan, tot, _ in outs):
        fail("train_step_4d gave a non-finite loss, a NaN or an overflow")


def pack_inputs(render_fn) -> tuple:
    """(slot, cum, counts) that `render_fn()` hands to the packing
    (ops.rasterize_cuda.PackSorted): a binning exactly as the render and
    training paths build it."""
    from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
    from ex4dgs_tpu_torch.runtime import graphs

    seen = []
    apply = trc.PackSorted.apply

    def spy(rows, order, cum, counts, slot):
        seen.append((slot, cum, counts))
        return apply(rows, order, cum, counts, slot)

    trc.PackSorted.apply = spy
    graphs.release("render")  # a render's first call with its key runs eagerly: spied on
    try:
        with torch.no_grad():
            render_fn()
    finally:
        trc.PackSorted.apply = apply
    return seen[0]


def kernels_phase(dev, scene, card: str) -> list[dict]:
    """The kernels phase (see the module's docstring): one row per
    hand-written kernel and shape, in the order of PERF.md's table of
    kernels, with its largest difference from its plain version and the ms
    per launch of both."""
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import cotangents, cuda_ms, pack_frame
    from ex4dgs_tpu_torch.ops import rasterize_cuda as trc
    from ex4dgs_tpu_torch.ops import slice4d as S
    from ex4dgs_tpu_torch.probes import outspec, readings_ms, unaligned
    from ex4dgs_tpu_torch.rendering import render
    from ex4dgs_tpu_torch.synthetic import ring_cameras
    from gsbench.families import fourdgs

    rows = []

    def events(fn, reps: int) -> float:  # back-to-back launches
        return cuda_ms(fn, reps=reps, warmup=1)

    def flushed(fn, reps: int) -> float:  # one launch after an L2 flush, the median
        return statistics.median(readings_ms(fn, dev, reps))

    def row(key: str, name: str, inputs: str, kernel, plain, check=held, timer=events,
            plain_reps: int = 3) -> None:
        source = next(s for s, fns in kernels.SOURCES.items() if name in fns)
        err = check(f"{key} {name}", kernel(), kernel(), plain())
        ms, plain_ms = timer(kernel, 20), timer(plain, plain_reps)
        rows.append({"id": key, "name": name, "source": f"ex4dgs_tpu_torch/csrc/{source}.cu",
                     "inputs": inputs, "max_err": err, "ms": ms, "plain_ms": plain_ms})
        log(f"# {key} {name}: {ms:.4f} ms a launch, plain {plain_ms:.4f} ms; {inputs}; {card}")

    f = pack_frame(scene)
    frame = (f"the bench frame at t=1, {scene.cam.width}x{scene.cam.height}, 32x16 tiles, "
             f"{int(f.stops[-1])} instances in {scene.capacity} slots")
    fwd, kw = (f.data, f.gid, f.starts, f.stops), dict(grid_x=f.grid_x, tile_x=32, tile_y=16)
    row("A", "composite_fwd", frame, lambda: kernels.composite_fwd(*fwd, track_idx=True, **kw),
        lambda: trc.composite_tiles_plain(*fwd, track_idx=True, **kw), check=hold_a,
        plain_reps=2)
    accum, tfinal, _ = kernels.composite_fwd(*fwd, track_idx=True, **kw)
    bwd = (f.data, f.starts, f.stops, *cotangents(accum), tfinal)
    row("B", "composite_bwd", frame + ", seeded cotangents",
        lambda: kernels.composite_bwd(*bwd, **kw),
        lambda: trc.composite_tiles_bwd_plain(*bwd, **kw),
        check=lambda what, got, again, want: hold_b(what, got, again, want, bwd, kw),
        plain_reps=2)
    del f, fwd, bwd, accum, tfinal

    src = unaligned.make_src(device=dev)
    offs = torch.from_numpy(unaligned.offset_sets()["unaligned"]).to(dev)
    row("P1", "probe_unaligned", f"{offs.numel()} [16, 256] windows of f32{list(src.shape)} "
        f"from arbitrary starts", lambda: kernels.probe_unaligned(src, offs, check_range=False),
        lambda: unaligned.copy_windows_plain(src, offs), timer=flushed, plain_reps=5)
    del src, offs
    ones = outspec.probe_inputs(outspec.T, dev)
    calls, plain = outspec.calls(outspec.T, dev, ones), outspec.plain_calls(outspec.T, dev, ones)
    for key in "abcde":
        row(f"P2{key}", f"outspec_{key}", f"{outspec.T} tiles, {outspec.LABELS[key]}",
            calls[key], plain[key], timer=flushed, plain_reps=5)
    del ones, calls, plain

    cell = load_cell("n3v_4dgs")
    sc = fourdgs.make_params(cell, 18, dev)
    P, span = sc["mask"].shape[0], fourdgs.time_span(cell)
    i32 = dict(dtype=torch.int32, device=dev)
    at = (torch.tensor(3.7, device=dev), torch.tensor([1.5, 4.0, -11.5], device=dev),
          torch.tensor(cell["sh_degree"], **i32), torch.tensor(cell["sh_degree_t"], **i32))
    g = torch.Generator(device=dev).manual_seed(19)
    cots = [torch.randn(s, generator=g, device=dev) for s in ((P, 3), (P, 6), (P,), (P, 3))]
    params = [sc["params"][k] for k in S.PARAMS]
    slicing = (f"the n3v_4dgs cell's model, {P} rows, SH degree {cell['sh_degree']} x time "
               f"degree {cell['sh_degree_t']}, t = 3.7 s")
    # the 0.05 marginal test may flip at a rounding in 2 rows per 100,000
    row("S1", "slice4d_fwd", slicing,
        lambda: kernels.slice4d_fwd(*params, sc["mask"], *at, span=span),
        lambda: S.slice4d_plain(*params, sc["mask"], *at, span=span),
        check=lambda *a: held(*a, rtol=S.SLICE_RTOL, flips=max(2, P // 50_000)))
    row("S2", "slice4d_bwd", slicing + ", seeded cotangents",
        lambda: kernels.slice4d_bwd(*params, *at, *cots, span=span),
        lambda: S.slice4d_bwd_plain(*params, *at, *cots, span=span),
        check=lambda *a: held(*a, rtol=S.SLICE_BWD_RTOL))
    del params, cots

    # the pack VJP on each training cell's binning: the bench frame (n3v),
    # the cell's model through one view at 16x16 with the exact sort (n3v_4dgs)
    prog = fourdgs.Program(cell, dev)
    cam = ring_cameras(8, 12.0, cell["width"], cell["height"], device=dev)[3]
    bg = torch.zeros(3, device=dev)
    binnings = {
        "V": ("the bench frame's binning (n3v)", pack_inputs(lambda: render(
            scene.cam, scene.model, scene.cfg, t=1.0, bg=bg, capacity=scene.capacity,
            device=dev))),
        "V4": ("the n3v_4dgs cell's binning, one view at 16x16 tiles with the exact sort, t = "
               "3.7 s", pack_inputs(lambda: prog.render(prog.model(sc), cam, 111)))}
    del sc
    for key, (inputs, (slot, cum, counts)) in binnings.items():
        capacity = slot.shape[0]
        live = min(int(cum[-1]), capacity)
        ct = torch.randn((16, capacity), generator=g, device=dev)
        ct[:, live:] = 0.0  # kernel B's gradient is 0 past the live instances
        vjp = (ct, slot, cum, counts)
        row(key, "pack_vjp", f"{inputs}: {live} instances in {capacity} slots, "
            f"{int((counts > 0).sum())} visible Gaussians, seeded cotangents",
            lambda: kernels.pack_vjp(*vjp), lambda: trc.pack_vjp_plain(*vjp))
        del ct, vjp
    return rows


PHASES = ("build", "scene", "render", "reference", "trainer", "eval", "quality", "multi_gpu",
          "bench", "fourdgs", "kernels")
NEEDS = {"render": "scene", "eval": "trainer"}  # a phase's set-up: another phase


def main(argv: list[str]) -> int:
    names = PHASES
    if argv:
        if argv[0] != "--only" or not argv[1:] or set(argv[1:]) - set(PHASES):
            fail(f"usage: python3 chip_smoke.py [--only NAME ...], NAME among {PHASES}")
        wanted = {"build", *argv[1:], *(NEEDS[n] for n in argv[1:] if n in NEEDS)}
        names = [n for n in PHASES if n in wanted]
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    import ex4dgs_tpu_torch  # noqa: F401  (sets the precision policy)
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.bench_frame import PROBE_CAPACITY, H, W, bench_scene, write_n3v_scene

    dev = torch.device("cuda")
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; phases {names}")
    done = {}

    def build():
        t0 = time.perf_counter()
        kernels.load_all()
        log(f"# build: {len(kernels.SOURCES)} sources, {len(kernels.launches)} kernel entry "
            f"points in {time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
        for name, text in kernels.build_logs.items():
            for line in text.strip().splitlines():
                log(f"#   {name}: {line.strip()}")

    def scene():
        t0 = time.perf_counter()
        s = done["scene"] = bench_scene(dev)
        if s.total > PROBE_CAPACITY:
            fail(f"bench scene overflows the {PROBE_CAPACITY} probe capacity ({s.total})")
        torch.cuda.synchronize()
        log(f"# scene: {s.model.static_capacity} + {s.model.dynamic_capacity} splats, {W}x{H}, "
            f"{s.total} instances at t=1 (capacity {s.capacity}), built in "
            f"{time.perf_counter() - t0:.2f} s")

    def trainer():
        done["model_dir"], done["trained"] = trainer_phase(dev, card, tmp)
        done["scene_dir"] = os.path.join(tmp, "scene")

    def multi_gpu():
        scene_dir = done.get("scene_dir") or write_n3v_scene(
            os.path.join(tmp, "scene"), n_cams=4, n_frames=8, n_points=100_000, seed=0)
        multi_gpu_phase(dev, scene_dir, card, tmp)

    def kernels_table():
        done["kernels"] = kernels_phase(dev, done.get("scene") or bench_scene(dev), card)

    run = {
        "build": build, "scene": scene,
        "render": lambda: done.update(fps=render_phase(dev, done["scene"], card)),
        "reference": reference_phase, "trainer": trainer,
        "eval": lambda: eval_phase(dev, done["model_dir"], done["trained"], done.get("fps"),
                                   card),
        "quality": lambda: quality_phase(dev, card, tmp), "multi_gpu": multi_gpu,
        "bench": lambda: bench_phase(card), "fourdgs": lambda: fourdgs_phase(dev, card),
        "kernels": kernels_table,
    }
    phase_s = []
    with tempfile.TemporaryDirectory(prefix="ex4dgs_smoke_") as tmp:
        for name in names:
            t0 = time.perf_counter()
            run[name]()
            torch.cuda.empty_cache()
            phase_s.append((name, time.perf_counter() - t0))
    log("# phase times (s): " + ", ".join(f"{n} {t:.1f}" for n, t in phase_s)
        + f"; total {sum(t for _, t in phase_s):.1f}")
    print(card, flush=True)
    if "kernels" in done:
        print(json.dumps({"kernels": done["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
