"""Reading the device from a `torch.profiler` trace of a few timed calls.

`profile_calls` runs calls under the profiler and reduces the trace to
what the per-layer metrics and the result's `breakdown` read: the device
time by operation, the seconds some operation ran on the device (the union
of their intervals), the wall time of the traced calls, and the device's
idle gaps named by the innermost host operation running at each gap.
"""
from __future__ import annotations

import time

import torch


def _merge(intervals):
    """Sorted, disjoint union of [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_calls(call, n: int, span: str, device) -> dict:
    """Run call(0) .. call(n - 1) under torch.profiler (each inside a
    `record_function(span)`; the calls may open spans of their own, named
    `gsbench.<part>`), the last ending in a synchronize, and summarise the
    trace (times in seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from .drive import sync

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with record_function(span):
                call(i)
        sync(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    dev, host = [], []
    for e in events:
        rng = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            # a record_function span leaves a device-side annotation over
            # the work it launched: a span, not an operation
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("gsbench."):
                dev.append((e.name, rng))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, rng))
    by_op: dict[str, float] = {}
    for name, (s, e) in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    busy = _merge([r for _, r in dev])
    gaps: dict[str, float] = {}
    host.sort(key=lambda x: x[1][0])
    stack, j = [], 0
    for (_, a_end), (b_start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a_end + b_start)
        while j < len(host) and host[j][1][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1][1] < mid:
            stack.pop()
        key = stack[-1][0] if stack else "(no host operation)"
        gaps[key] = gaps.get(key, 0.0) + (b_start - a_end)
    return {"calls": n, "wall_s": wall, "busy_s": sum(e - s for s, e in busy),
            "by_op": by_op, "idle_by_host_op": gaps}


def breakdown(prof: dict, top: int = 10) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the idle time by what the host was doing, in seconds."""
    def head(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": head(prof["by_op"]), "idle_gaps": head(prof["idle_by_host_op"])}


def kernel_seconds(prof: dict, kernel: str) -> float | None:
    """Device seconds of the operations whose name contains `kernel`, or
    None when the trace holds none."""
    t = [v for k, v in prof["by_op"].items() if kernel in k]
    return sum(t) if t else None
