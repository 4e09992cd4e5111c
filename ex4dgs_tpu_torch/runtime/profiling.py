"""Profiling and step timing.

Counterpart of `ex4dgs_tpu/runtime/profiling.py`. The reference only has
torch.cuda.Event pairs around the step (train.py:70-71,108,175). Here: a
streaming step timer with percentile summaries and Mpixels/s derivation,
a `torch.profiler` trace context that writes a Chrome trace, and a
roofline placement against the H100's data-sheet peaks.
"""
from __future__ import annotations

import contextlib
import os
import time

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
