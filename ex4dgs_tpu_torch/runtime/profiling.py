"""Profiling and step timing.

Counterpart of `ex4dgs_tpu/runtime/profiling.py`. The reference only has
torch.cuda.Event pairs around the step (train.py:70-71,108,175). Here: a
streaming step timer with percentile summaries and Mpixels/s derivation,
a `torch.profiler` trace context that writes a Chrome trace, the device
time of a few calls by kernel and the device busy share
(`profile_calls`, `device_busy_share`: the bench and chip_smoke.py read
them), a roofline placement against the H100's data-sheet peaks, and
`host_syncs`, which finds the calls that make the host wait for the card.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; fp32 outside the tensor
# cores counted in instruction slots (132 SMs x 128 lanes x the 1.98 GHz
# boost clock, an FMA counting as one: the data sheet's 67 TFLOP/s counts it
# as two), as chip_smoke.py counts the kernels' bounds. Both assume the
# full 700 W power limit.
H100_HBM_BYTES_S = 3.35e12
H100_FP32_SLOTS_S = 132 * 128 * 1.98e9


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host and CUDA activity with torch.profiler and
    write `<log_dir>/trace.json` (Chrome trace format; open in Perfetto or
    chrome://tracing)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_calls(fn, n: int = 3, top: int = 12):
    """Where a call's time goes on the current CUDA device: torch.profiler
    over n calls of fn(), the last ending in `torch.cuda.synchronize()`.
    Returns (wall ms per call under the profiler, device ms per call,
    device events per call, [(kernel, device ms per call, launches per
    call)] for the `top` kernels by device time), or None when the profiler
    saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
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


def device_busy_share(fn, wall_ms: float, n: int = 3) -> tuple:
    """(device ms per call of fn(), its share of `wall_ms`): the device
    time of every kernel and copy over n calls under torch.profiler
    (`profile_calls`) over the call's wall time measured without the
    profiler. The profiler slows the host, so the wall time under it would
    understate the share. (None, None) when the profiler saw no device
    time."""
    breakdown = profile_calls(fn, n)
    if breakdown is None:
        return None, None
    return breakdown[1], breakdown[1] / wall_ms


class StepTimer:
    """Wall-time tracker for steps; call stop() with a tensor to wait for
    its device (accurate timing of asynchronous CUDA work)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.times: list[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, block_on: torch.Tensor | None = None) -> float:
        if block_on is not None and block_on.device.type == "cuda":
            torch.cuda.synchronize(block_on.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def summary(self, pixels: int | None = None) -> dict:
        arr = np.asarray(self.times)
        if arr.size == 0:
            return {}
        out = {
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "steps_per_s": float(1.0 / arr.mean()),
        }
        if pixels:
            out["mpixels_per_s"] = float(pixels / arr.mean() / 1e6)
        return out


def host_syncs(fn) -> list[str]:
    """The calls in fn that make the host wait for the card: [] when there
    are none. fn runs once under torch.cuda.set_sync_debug_mode("error");
    if a call raises there, fn runs again under "warn" and the result lists
    every warning's file:line (the Python line that made the call). The
    mode is restored either way; on a host without CUDA nothing runs."""
    if not torch.cuda.is_available():
        return []
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            return []
        except RuntimeError as first:
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
            found = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
                     if "synchronizing" in str(w.message)]
            return found or [f"(no warning on the second run) {first}"]
    finally:
        torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()


def roofline(flops: float, bytes_accessed: float, seconds: float,
             peak_flops: float = H100_FP32_SLOTS_S, peak_bw: float = H100_HBM_BYTES_S) -> dict:
    """Roofline placement of a measured kernel; the defaults are one H100
    SXM's fp32 instruction-slot rate and HBM3 rate (see above), so `flops`
    counts fp32 instructions with an FMA as one."""
    achieved = flops / seconds
    intensity = flops / max(bytes_accessed, 1)
    bound = min(peak_flops, intensity * peak_bw)
    return {
        "achieved_tflops": achieved / 1e12,
        "intensity_flops_per_byte": intensity,
        "roof_tflops": bound / 1e12,
        "efficiency": achieved / bound,
        "memory_bound": bool(intensity * peak_bw < peak_flops),
    }
