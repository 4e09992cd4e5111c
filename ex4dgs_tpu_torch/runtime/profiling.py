"""Profiling: program spans, traces and host-read checks.

Counterpart of `ex4dgs_tpu/runtime/profiling.py`. The reference only has
torch.cuda.Event pairs around the step (train.py:70-71,108,175). Here:

* `span(name)`: a layer boundary of the main paths (`train_step`, `render`
  and the layers under them, all named `ex4dgs.<layer>`). While a profiler
  runs it opens a `record_function` (so the layer has a name in the device
  trace) and records the span in memory; `span_summary()` gives each
  layer's host time per outermost call, `span_records()` the record on the
  trace's clock, `span_reset()` clears it. With no profiler it costs one
  flag check.
* `trace(log_dir)`: a Chrome trace of the block, and `spans.json`, each
  span's host and device time per outermost call (`device_table`).
* `host_syncs`: the calls that make the host wait for the card.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from typing import NamedTuple

import torch

_autograd_profiler = torch.autograd.profiler
_NULL = contextlib.nullcontext()
_CPU = torch.autograd.DeviceType.CPU
SPAN_PREFIX = "ex4dgs."
OUTSIDE = "(no program span)"  # device work launched outside every program span


class SpanRecord(NamedTuple):
    """A closed span. `parent` is the innermost span open on its thread when
    it opened or, on a thread with nothing open, the innermost span open in
    the current call (the autograd engine's device thread, where the custom
    Functions' backward runs on CUDA); None for an outermost span. Every
    span under an outermost one shares its `call`. Times are host ns. The
    rule takes calls to run one at a time: a span opened on a thread with
    nothing open while another thread's call is open joins that call."""

    name: str
    span: int
    parent: int | None
    call: int
    thread: int
    start_ns: int
    end_ns: int


# The in-memory record: spans in the order they closed, and one
# (perf_counter_ns, time_ns) pair per call, which places the call's spans on
# the profiler's clock (the epoch's). Filled only while a profiler runs.
_RECORD: list[SpanRecord] = []
_CLOCKS: dict[int, tuple[int, int]] = {}
_OPEN: dict[int, list[tuple[int, int]]] = {}  # thread -> [(span, call)] open on it
_CALLER: list[int | None] = [None]  # the thread whose outermost span is open
_SPAN_IDS = itertools.count(1)
_CALL_IDS = itertools.count(1)


class _Span:
    __slots__ = ("name", "_rf", "_key", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        thread = threading.get_ident()
        stack = _OPEN.setdefault(thread, [])
        caller = _OPEN.get(_CALLER[0]) if _CALLER[0] != thread else None
        if stack:
            parent, call = stack[-1]
        elif caller:
            parent, call = caller[-1]
        else:
            parent, call = None, next(_CALL_IDS)
            _CALLER[0] = thread
            _CLOCKS[call] = (time.perf_counter_ns(), time.time_ns())
        sid = next(_SPAN_IDS)
        stack.append((sid, call))
        self._key = (sid, parent, call, thread)
        self._rf = _autograd_profiler.record_function(self.name)
        self._rf.__enter__()
        # stamped inside the record_function, so the record's interval is
        # the profiler event's less the enter and exit themselves
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        sid, parent, call, thread = self._key
        _OPEN[thread].pop()
        if parent is None:
            _CALLER[0] = None
        _RECORD.append(SpanRecord(self.name, sid, parent, call, thread, self._t0, t1))
        return False


def span(name: str):
    """A context manager around one layer of a main path. With no profiler
    active it is one shared null context, after one flag check: nothing
    allocated, recorded or launched. With one active it opens
    `record_function(name)` and records the span (`span_summary`). It never
    reads the device nor synchronises."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def span_reset() -> None:
    """Clear the record (spans still open are recorded when they close, and
    their calls keep their clock pairs)."""
    _RECORD.clear()
    open_calls = {call for stack in list(_OPEN.values()) for _, call in stack}
    for call in [c for c in _CLOCKS if c not in open_calls]:
        del _CLOCKS[call]


def span_records() -> list[SpanRecord]:
    """The record, each span's times placed on the profiler's clock (epoch
    ns, as `kineto_results.trace_start_ns()` plus an event's time_range)
    by its call's clock pair."""
    out = []
    for r in _RECORD:
        perf, epoch = _CLOCKS[r.call]
        out.append(r._replace(start_ns=r.start_ns - perf + epoch,
                              end_ns=r.end_ns - perf + epoch))
    return out


def _covered(intervals, lo, hi) -> int:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def _summarise(records) -> dict:
    """span_summary's arithmetic over SpanRecord-like tuples."""
    kids: dict[int, list] = {}
    for r in records:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    calls = len({r.call for r in records})
    rows: dict[str, list] = {}
    for r in records:
        total = r.end_ns - r.start_ns
        under = _covered(kids.get(r.span, ()), r.start_ns, r.end_ns)
        row = rows.setdefault(r.name, [0, 0, 0, False])
        row[0] += 1
        row[1] += total
        row[2] += total - under
        row[3] |= r.span in kids
    spans = {}
    for name, (count, total, self_ns, _) in rows.items():
        spans[name] = {"count": count, "total_ms": total / 1e6, "self_ms": self_ns / 1e6,
                       "total_ms_per_call": total / 1e6 / calls,
                       "self_ms_per_call": self_ns / 1e6 / calls}
    coverage = {name: 1.0 - self_ns / total for name, (_, total, self_ns, has) in rows.items()
                if has and total > 0}
    return {"calls": calls, "spans": spans, "coverage": coverage}


def span_summary() -> dict:
    """The record by span name: {"calls": outermost calls, "spans": {name:
    {count, total_ms, self_ms, total_ms_per_call, self_ms_per_call}},
    "coverage": {name: share of the span's host time its children cover,
    for each span that has children}}. Self time is a span's duration less
    the union of its children's intervals."""
    return _summarise(list(_RECORD))


# ---------------------------------------------------------------------------
# The operator's trace and device table
# ---------------------------------------------------------------------------

def device_table(events) -> dict:
    """spans.json: per outermost call, each span name's host ms (total and
    self), the device ms and count of the device operations charged to it.
    The spans are the profiler's host events named `ex4dgs.*`, parented as
    `span` parents them. An operation is charged to the innermost span open
    on the thread that launched it, when it was launched: the profiler gives
    a kernel, copy or fill the correlation id of the CUDA runtime or driver
    call (a host event named `cu*`) that launched it. Where that thread has
    no span open, it is charged to the innermost span open in the call
    (`ex4dgs.backward` for autograd's device thread); else to OUTSIDE.
    Device-side span annotations (`is_user_annotation`) are not work.
    `events`: the profiler's events (`prof.events()`) or lookalikes."""
    # an operator's own id may equal a launch's: only the cu* calls launch
    launches = {e.id: e for e in events if e.device_type == _CPU and e.name.startswith("cu")}
    work: dict[int, list] = {}  # launch id -> [device ms, operations]
    unlaunched = [0.0, 0]
    for e in events:
        if e.device_type != _CPU and not getattr(e, "is_user_annotation", False):
            row = work.setdefault(e.id, [0.0, 0]) if e.id in launches else unlaunched
            row[0] += (e.time_range.end - e.time_range.start) / 1e3
            row[1] += 1
    found = [e for e in events if e.device_type == _CPU and not e.is_async
             and e.name.startswith(SPAN_PREFIX)] + [launches[i] for i in work]
    found.sort(key=lambda e: (e.time_range.start, not e.name.startswith(SPAN_PREFIX)))
    stacks: dict[int, list[SpanRecord]] = {}  # thread -> its spans open at the current start
    spans: list[SpanRecord] = []
    charged: dict[str, list] = {OUTSIDE: unlaunched}
    for e in found:
        s = int(e.time_range.start * 1e3)
        for st in stacks.values():
            while st and st[-1].end_ns < s:
                st.pop()
        own = stacks.setdefault(e.thread, [])
        tops = own[-1:] or [st[-1] for st in stacks.values() if st]
        inner = max(tops, key=lambda p: p.start_ns) if tops else None
        if e.name.startswith(SPAN_PREFIX):
            rec = SpanRecord(e.name, len(spans), inner and inner.span,
                             inner.call if inner else len(spans), e.thread, s,
                             int(e.time_range.end * 1e3))
            spans.append(rec)
            own.append(rec)
        else:
            row = charged.setdefault(inner.name if inner else OUTSIDE, [0.0, 0])
            row[0] += work[e.id][0]
            row[1] += work[e.id][1]
    table = _summarise(spans)
    calls = max(table["calls"], 1)
    out = {}
    for name in list(table["spans"]) + [n for n in charged if n not in table["spans"]]:
        host = table["spans"].get(name)
        dev_ms, ops = charged.get(name, (0.0, 0))
        if host is None and not ops:
            continue
        out[name] = {"host_ms": host["total_ms_per_call"] if host else 0.0,
                     "host_self_ms": host["self_ms_per_call"] if host else 0.0,
                     "device_ms": dev_ms / calls, "device_ops": ops / calls}
    return {"calls": table["calls"], "per_call": out, "coverage": table["coverage"]}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host and CUDA activity with torch.profiler and
    write `<log_dir>/trace.json` (Chrome trace format; open in Perfetto or
    chrome://tracing), in which the program's spans are named, and
    `<log_dir>/spans.json`, the spans' host and device time per outermost
    call (`device_table`)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(device_table(prof.events()), f, indent=1)


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
