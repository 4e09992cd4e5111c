"""The program's layer spans (`runtime/profiling.py::span`) on the CPU.

- With no profiler active, a train_step and a render make one flag check a
  span and nothing else: no record, no record_function.
- Under torch.profiler a train_step records every layer span with its
  parent, the backward spans under `ex4dgs.backward` in the step's call,
  one call per step; a span on another thread takes the call's innermost
  span as its parent; spans on many threads at once lose nothing.
- The record, placed on the trace's clock, lies on the profiler's events.
- Outputs are bit-equal with the profiler on and off.
- span_summary's arithmetic and device_table's charging rule on
  hand-built records and events.
"""
import statistics
import sys
import threading
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ex4dgs_tpu_torch.models.config import OptimizationConfig
from ex4dgs_tpu_torch.models.optimizer import init_state
from ex4dgs_tpu_torch.rendering import default_capacity, render
from ex4dgs_tpu_torch.runtime import profiling
from ex4dgs_tpu_torch.runtime.profiling import SpanRecord
from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
from ex4dgs_tpu_torch.train.step import StepStatics, train_step

torch.set_num_threads(2)

# span -> its parent's name in a train_step
STEP_PARENTS = {
    "ex4dgs.train_step": None,
    "ex4dgs.render": "ex4dgs.train_step",
    "ex4dgs.temporal": "ex4dgs.render",
    "ex4dgs.preprocess": "ex4dgs.render",
    "ex4dgs.binning": "ex4dgs.render",
    "ex4dgs.composite": "ex4dgs.render",
    "ex4dgs.loss": "ex4dgs.train_step",
    "ex4dgs.backward": "ex4dgs.train_step",
    "ex4dgs.backward.pack": "ex4dgs.backward",
    "ex4dgs.backward.composite": "ex4dgs.backward",
    "ex4dgs.update": "ex4dgs.train_step",
}
RENDER_SPANS = 5  # render, temporal, preprocess, binning, composite


@pytest.fixture(scope="module")
def small():
    dev = torch.device("cpu")
    model, cfg = make_scene(n_static=1000, n_dynamic=100, duration=10.0, seed=1, device=dev)
    cam = ring_cameras(1, 3.0, 96, 64, far=cfg.far, device=dev)[0]
    cap = default_capacity(model.static_capacity + model.dynamic_capacity, 96, 64)
    statics = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                          capacity=cap)
    gt = torch.rand((64, 96, 3), generator=torch.Generator().manual_seed(2))
    bg = torch.full((3,), 0.25)

    def step():
        return train_step(model, init_state(model.params, device=dev), cam, gt, 2.5, bg, 700,
                          statics, device=dev)

    def frame():
        return render(cam, model, cfg, t=7.5, bg=bg, capacity=cap, device=dev)

    return SimpleNamespace(step=step, frame=frame)


@pytest.fixture
def clean_record():
    profiling.span_reset()
    yield
    profiling.span_reset()


def _profiled(fn, n: int = 1):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [fn() for _ in range(n)]
    return outs, prof


def test_spans_off_check_one_flag_and_nothing_else(small, clean_record, monkeypatch):
    reads = []

    class Flag:
        def __getattr__(self, name):
            reads.append(name)
            if name != "_is_profiler_enabled":
                raise AttributeError(name)
            return False

    def no_record_function(*args, **kwargs):
        raise AssertionError("a record_function was entered with no profiler")

    monkeypatch.setattr(profiling, "_autograd_profiler", Flag())
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_record_function)
    assert profiling.span("ex4dgs.a") is profiling.span("ex4dgs.b")
    reads.clear()
    small.step()
    assert reads == ["_is_profiler_enabled"] * len(STEP_PARENTS)
    reads.clear()
    small.frame()
    assert reads == ["_is_profiler_enabled"] * RENDER_SPANS
    assert profiling.span_summary() == {"calls": 0, "spans": {}, "coverage": {}}
    assert not profiling._RECORD


def test_train_step_records_every_span_with_its_parent(small, clean_record):
    _profiled(small.step, 2)
    recs = profiling._RECORD
    by_id = {r.span: r for r in recs}
    calls = sorted({r.call for r in recs})
    assert len(calls) == 2 and profiling.span_summary()["calls"] == 2
    for call in calls:
        mine = [r for r in recs if r.call == call]
        assert sorted(r.name for r in mine) == sorted(STEP_PARENTS)
        for r in mine:
            parent = by_id[r.parent].name if r.parent is not None else None
            assert parent == STEP_PARENTS[r.name], r
            if r.parent is not None:
                p = by_id[r.parent]
                assert p.call == call and p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    summary = profiling.span_summary()
    assert {n: s["count"] for n, s in summary["spans"].items()} == dict.fromkeys(STEP_PARENTS, 2)
    assert set(summary["coverage"]) == {"ex4dgs.train_step", "ex4dgs.render", "ex4dgs.backward"}
    assert all(0.5 < c <= 1.0 for c in summary["coverage"].values())
    assert not any("composite_fwd_kernel" in n or "composite_bwd_kernel" in n
                   for n in STEP_PARENTS)


def test_a_span_on_another_thread_takes_the_calls_innermost_span(clean_record):
    def worker():  # as autograd's device thread runs a custom Function's backward
        with profiling.span("ex4dgs.backward.pack"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("ex4dgs.train_step"), profiling.span("ex4dgs.backward"):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
        assert not th.is_alive()
        with profiling.span("ex4dgs.render"):
            pass
    by_name = {r.name: r for r in profiling._RECORD}
    step, bwd, pack = (by_name[n] for n in ("ex4dgs.train_step", "ex4dgs.backward",
                                            "ex4dgs.backward.pack"))
    assert pack.thread != bwd.thread and pack.parent == bwd.span and pack.call == step.call
    assert by_name["ex4dgs.render"].parent is None
    assert by_name["ex4dgs.render"].call != step.call


def test_spans_on_many_threads_at_once_lose_nothing(clean_record):
    """More threads than cores, switching often: every span is recorded
    once, under its own thread's open span, and nothing stays open."""
    n_threads, n_spans = 16, 200

    def worker():
        for _ in range(n_spans):
            with profiling.span("ex4dgs.outer"), profiling.span("ex4dgs.inner"):
                pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=worker) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(before)
    recs = profiling._RECORD
    by_id = {r.span: r for r in recs}
    assert len(recs) == len(by_id) == 2 * n_threads * n_spans
    inner = [r for r in recs if r.name == "ex4dgs.inner"]
    assert all(by_id[r.parent].name == "ex4dgs.outer" and by_id[r.parent].thread == r.thread
               and by_id[r.parent].call == r.call for r in inner)
    assert not any(profiling._OPEN.values())


def test_the_record_lies_on_the_profilers_clock(small, clean_record):
    _, prof = _profiled(small.step, 2)
    start = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)),
                    key=lambda e: e.time_range.start)
    recs = sorted(profiling.span_records(), key=lambda r: r.start_ns)
    assert [e.name for e in events] == [r.name for r in recs]
    d0, d1 = [], []
    for e, r in zip(events, recs):
        e0, e1 = start + e.time_range.start * 1e3, start + e.time_range.end * 1e3
        d0.append(abs(e0 - r.start_ns))
        d1.append(abs(e1 - r.end_ns))
        assert max(e0, r.start_ns) < min(e1, r.end_ns), (e.name, d0[-1], d1[-1])
    # each end a few us apart (the record_function's own enter and exit);
    # the profiler's first span pays its lazy set-up (~1 ms here) once
    assert statistics.median(d0) < 100e3 and statistics.median(d1) < 100e3, (d0, d1)


def test_outputs_are_bit_equal_with_the_profiler_on_and_off(small, clean_record):
    off_step, off_frame = small.step(), small.frame()
    (on_step,), _ = _profiled(small.step)
    (on_frame,), _ = _profiled(small.frame)
    assert profiling._RECORD

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in leaves(x[k])]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in leaves(v)]
        if hasattr(x, "__dataclass_fields__"):
            return [t for k in x.__dataclass_fields__ for t in leaves(getattr(x, k))]
        return []

    for off, on in ((off_step, on_step), (off_frame, on_frame)):
        a, b = leaves(off), leaves(on)
        assert len(a) == len(b) > 5
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _rec(name, span, parent, call, start, end, thread=1):
    return SpanRecord(name, span, parent, call, thread, start, end)


def test_span_summary_arithmetic(clean_record, monkeypatch):
    ms = 1_000_000
    monkeypatch.setattr(profiling, "_RECORD", [
        _rec("b", 2, 1, 1, 10 * ms, 40 * ms),
        _rec("c", 3, 1, 1, 30 * ms, 60 * ms),  # overlaps b: the union counts once
        _rec("d", 4, 2, 1, 20 * ms, 30 * ms),
        _rec("e", 5, 1, 1, 70 * ms, 120 * ms, thread=2),  # clipped at a's end
        _rec("a", 1, None, 1, 0, 100 * ms),
        _rec("a", 6, None, 2, 200 * ms, 250 * ms),
    ])
    s = profiling.span_summary()
    assert s["calls"] == 2
    a, b = s["spans"]["a"], s["spans"]["b"]
    assert a["count"] == 2 and a["total_ms"] == pytest.approx(150.0)
    assert a["self_ms"] == pytest.approx(100 - 50 - 30 + 50)
    assert a["total_ms_per_call"] == pytest.approx(75.0)
    assert a["self_ms_per_call"] == pytest.approx(35.0)
    assert b["total_ms"] == pytest.approx(30.0) and b["self_ms"] == pytest.approx(20.0)
    assert s["spans"]["e"]["self_ms_per_call"] == pytest.approx(25.0)
    assert s["coverage"] == pytest.approx({"a": 1 - 70 / 150, "b": 10 / 30})


def _ev(name, start_us, end_us, *, id=0, thread=1, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, id=id, thread=thread, device_type=device, is_async=False,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def test_device_table_charges_each_operation_to_its_launchers_span():
    cuda = DeviceType.CUDA
    events = [
        _ev("ex4dgs.train_step", 0, 1000, id=1),
        _ev("ex4dgs.backward", 400, 900, id=2),
        _ev("ex4dgs.backward.pack", 500, 600, id=3, thread=2),  # autograd's thread
        _ev("aten::mul", 100, 110, id=10),
        _ev("cudaLaunchKernel", 102, 108, id=50),
        _ev("aten::add", 450, 460, id=11, thread=2),  # autograd's thread, no span there
        _ev("cudaLaunchKernel", 452, 458, id=51, thread=2),
        _ev("cudaLaunchKernel", 552, 554, id=52, thread=2),
        _ev("cuLaunchKernel", 556, 558, id=53, thread=2),
        _ev("cudaMemcpyAsync", 1102, 1108, id=54),  # after the call
        _ev("aten::as_strided", 1200, 1201, id=50),  # an operator's id, not a launch
        _ev("mul_kernel", 2000, 7000, id=50, device=cuda),
        _ev("add_kernel", 2000, 9000, id=51, device=cuda),
        _ev("scan_kernel", 3000, 6000, id=52, device=cuda),
        _ev("scan_kernel", 6000, 7000, id=53, device=cuda),
        _ev("Memcpy DtoH", 8000, 10000, id=54, device=cuda),
        _ev("ex4dgs.train_step", 0, 20000, id=1, device=cuda, annotation=True),
    ]
    t = profiling.device_table(events)
    assert t["calls"] == 1
    rows = t["per_call"]
    want = {"ex4dgs.train_step": (5.0, 1), "ex4dgs.backward": (7.0, 1),
            "ex4dgs.backward.pack": (4.0, 2), profiling.OUTSIDE: (2.0, 1)}
    assert {n: (r["device_ms"], r["device_ops"]) for n, r in rows.items()} == \
        pytest.approx(want)
    assert rows["ex4dgs.train_step"]["host_ms"] == pytest.approx(1.0)
    assert rows["ex4dgs.train_step"]["host_self_ms"] == pytest.approx(0.5)
    assert rows["ex4dgs.backward"]["host_self_ms"] == pytest.approx(0.4)
    assert t["coverage"] == pytest.approx({"ex4dgs.train_step": 0.5,
                                           "ex4dgs.backward": 0.2})
