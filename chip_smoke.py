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
    return entries


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
    log(f"# build: {len(kernels.SOURCES)} sources, {len(kernels.launches)} kernel entry points "
        f"in {time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
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

    probe_entries = probe_phase(dev, starts, stops, card)

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
    }, *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
