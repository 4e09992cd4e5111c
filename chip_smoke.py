"""Drive the PyTorch/CUDA port's render path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit and no result line):

1. build: compile every CUDA kernel of the render path from
   ex4dgs_tpu_torch/csrc/ with nvcc (sm_90a), print the build time and
   ptxas' register/shared-memory report.
2. scene: the bench scene of bench.py at full width (100k static + 10k
   dynamic splats, 1352x1014, scaling clamped to log(0.02)); the instance
   buffer is sized as bench.py sizes it (probe at 2M, then
   round_capacity(total * 5 // 4, 65536)).
3. kernel vs plain: one frame's packed instances go through the
   forward-compositing kernel and through its plain PyTorch version on the
   card; accum and tfinal must agree within 2e-5, the normalised depth
   within 1e-4 and the dominant ids on >= 99.9% of pixels. Both are timed
   with CUDA events, and the least time the card could take for the same
   work is computed from this frame's data.
4. main path: rendering.render at t = 0, 1, 2.5, 4, 7.5 with track_idx True
   and False, then the FPS recipe of eval/render_sets.py (per-call host
   timing ending in torch.cuda.synchronize, warm-up calls dropped). Every
   launch counter is set to 0 just before and read just after; each kernel
   of the path must have launched, every output must be finite, no frame may
   overflow its capacity and no image may be all background.
5. reference: a small scene rendered on the card and on the CPU (plain
   path) must agree.

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
    """Where a frame's time goes: torch.profiler over n frames. Returns
    (wall ms per frame under the profiler, device ms per frame, [(kernel,
    device ms per frame, launches per frame)] for the `top` kernels by
    device time), or None when the profiler saw no device time."""
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
    return wall_ms, sum(r[1] for r in rows), rows[:top]


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


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    import ex4dgs_tpu_torch  # noqa: F401  (sets the precision policy)
    from ex4dgs_tpu_torch import kernels
    from ex4dgs_tpu_torch.models.state import round_capacity
    from ex4dgs_tpu_torch.models.temporal import point_data_at_t
    from ex4dgs_tpu_torch.ops.binning import bin_gaussians
    from ex4dgs_tpu_torch.ops.projection import tile_grid
    from ex4dgs_tpu_torch.ops.rasterize_cuda import composite_tiles_plain, pack_sorted
    from ex4dgs_tpu_torch.rendering import preprocess_points, render
    from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras

    dev = torch.device("cuda")
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    for name in kernels.launches:
        kernels.load(name)
    log(f"# build: {len(kernels.launches)} kernel(s) in {time.perf_counter() - t0:.2f} s")
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

    # -- 3. kernel vs plain ---------------------------------------------
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

    ms = cuda_ms(lambda: kernels.composite_fwd(*args, **kw), reps=20)
    ms_noidx = cuda_ms(lambda: kernels.composite_fwd(*args, **{**kw, "track_idx": False}),
                       reps=20)
    plain_ms = cuda_ms(lambda: composite_tiles_plain(*args, **kw), reps=2, warmup=1)
    evaluated, applied = walked_pairs(data, starts, stops, gx, tx, ty)
    n_inst = int(stops[-1].item() - starts[0].item())
    T, npix = starts.shape[0], tx * ty
    nbytes = 14 * 4 * n_inst + 4 * n_inst + 2 * 4 * T + T * npix * (8 + 1 + 1) * 4
    slots = SLOTS_EVAL * evaluated + SLOTS_APPLIED * applied
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_fp32 = slots / FP32_SLOTS_S * 1e3
    t_sfu = evaluated / SFU_OPS_S * 1e3
    bound_ms = max(t_bytes, t_fp32, t_sfu)
    log(f"# composite_fwd: {ms:.4f} ms/frame (track_idx=False {ms_noidx:.4f}), plain "
        f"{plain_ms:.2f} ms; {n_inst} instances in {T} tiles; pairs evaluated {evaluated}, "
        f"applied {applied}; bound {bound_ms:.4f} ms (bytes {t_bytes:.4f}, fp32 "
        f"{t_fp32:.4f}, sfu exp {t_sfu:.4f}); {card}")

    # -- 4. main path ----------------------------------------------------
    def frame(t, track_idx):
        return render(cam, model, cfg, t=t, bg=bg, capacity=capacity, track_idx=track_idx,
                      device=dev)

    for track_idx in (True, False):  # warm-up: allocator, caches
        frame(1.0, track_idx)
    torch.cuda.synchronize()

    kernels.reset_launches()
    n_frames = 0
    sweep = []
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
            sweep.append((t, track_idx, tot, dt))
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
    launches = dict(kernels.launches)
    log(f"# main path: {n_frames} renders, launches {launches}")
    for name, n in launches.items():
        if n < n_frames:
            fail(f"kernel {name} launched {n} times in {n_frames} renders")
    for track_idx, ms_f in fps.items():
        log(f"# FPS recipe t=1 track_idx={track_idx}: {ms_f:.3f} ms/frame, "
            f"{W * H / ms_f / 1e3:.2f} Mpix/s, {1e3 / ms_f:.1f} FPS; {card}")
    torch.cuda.reset_peak_memory_stats()
    breakdown = profile_frames(lambda: frame(1.0, True))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if breakdown is None:
        log("# profile t=1 track_idx=True: device time not measured (the profiler "
            f"saw no device activity); peak memory {peak_gib:.2f} GiB")
    else:
        wall_p, dev_p, rows = breakdown
        log(f"# profile t=1 track_idx=True (torch.profiler, 3 frames): {wall_p:.3f} ms/frame "
            f"wall under the profiler, {dev_p:.3f} ms/frame device busy "
            f"({100 * dev_p / wall_p:.1f}%), peak memory {peak_gib:.2f} GiB; {card}")
        for name, ms_k, count in rows:
            log(f"#   {ms_k:8.4f} ms  x{count:5.1f}  {name[:100]}")

    # -- 5. reference on a small input ----------------------------------
    small = {}
    for d in ("cuda", "cpu"):
        m_s, c_s = make_scene(n_static=3000, n_dynamic=300, duration=10.0, seed=1, device=d)
        cam_s = ring_cameras(1, 3.0, 160, 96, far=c_s.far, device=d)[0]
        small[d] = render(cam_s, m_s, c_s, t=2.5, bg=torch.tensor([0.1, 0.2, 0.3]).to(d),
                          capacity=65536, device=d)
    g, c = small["cuda"], small["cpu"]
    err_small = (g.render.cpu() - c.render).abs().max().item()
    err_small_acc = (g.acc.cpu() - c.acc).abs().max().item()
    agree_small = (g.dominent_idxs.cpu() == c.dominent_idxs).float().mean().item()
    log(f"# small scene 160x96, cuda vs cpu: color {err_small:.3g}, acc {err_small_acc:.3g} "
        f"(atol 1e-4), idx agreement {agree_small:.5f} (>= 0.99), instances "
        f"{int(g.binning_total)} vs {int(c.binning_total)}")
    if not (err_small <= 1e-4 and err_small_acc <= 1e-4 and agree_small >= 0.99):
        fail("the card's render of the small scene disagrees with the CPU's")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "ex4dgs_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "ex4dgs_tpu/ops/rasterize_pallas.py:439",
        "launches": launches["composite_fwd"],
        "max_abs_err": max(err_acc, err_tf),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= max(t_fp32, t_sfu) else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
