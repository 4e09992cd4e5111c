"""What the metric readers (`metrics/<name>.py`) share: each reads a run's
record (`drive.run_cell`) and returns a number, or None when the run has
nothing for it to read (another kind of cell, or no trace)."""
from __future__ import annotations

import numpy as np

from . import counts, trace


def per_call_s(run: dict) -> float:
    """The window's seconds over the calls completed in it."""
    return run["window_s"] / run["calls"]


def idle_share(run: dict):
    """% of a call's wall time (the untraced window's) in which no
    operation ran on the device (the traced calls' busy seconds)."""
    prof = run.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["calls"] / per_call_s(run))


def dispatch_ms(run: dict):
    """Mean host ms from an entry-point call to its return (no sync) over
    the window's calls."""
    if not run["dispatch_s"]:
        return None
    return 1e3 * float(np.mean(run["dispatch_s"]))


def roofline(run: dict, kernel: str, work) -> float | None:
    """% of the traced calls' device seconds of `kernel` that the least
    time for their work (work(census) -> (FLOPs, bytes)) takes."""
    prof = run.get("profile")
    seconds = trace.kernel_seconds(prof, kernel) if prof else None
    if not seconds:
        return None
    flops = nbytes = 0
    for w in run["work"]():
        f, b = work(w)
        flops, nbytes = flops + f, nbytes + b
    return 100.0 * counts.least_seconds(flops, nbytes) / seconds


def mfu(run: dict, flops_of) -> float | None:
    """% of the float32 peak that the traced calls' FLOPs take over their
    calls' time in the untraced window."""
    if not run.get("profile"):
        return None
    works = run["work"]()
    flops = sum(flops_of(w) for w in works)
    return 100.0 * flops / (len(works) * per_call_s(run) * counts.PEAK_FP32_FLOPS)
