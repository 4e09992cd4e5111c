"""The general traffic generator: one closed-loop client of the program, set up
from a configuration and a traffic mix, both plain data.

The configuration's model family (`families/<family>.py`) gives the program
under test (`Program`) and its scene. A mix's `kind` names the entry point
it drives:
  * `train`: the family's training step in a closed loop, its state
    carried from step to step as the trainer carries it, over a pool of
    ground-truth images on the device, each step taking the family's
    `VIEWS_PER_STEP` entries of the pool's schedule;
  * `render`: the family's render as the trainer's viewer calls it, one
    client asking for the next frame when it has the last, each frame read
    back to the host as the viewer reads it before its reply (the reply's
    conversion to bytes is left out: the check makes the bytes afterwards).
Everything else in a mix is a number the generator reads. `run_cell` returns
the run's record: what the metrics' readers and the correctness check
read.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from . import check, families, scene, trace


def _no_spans(name):
    return contextlib.nullcontext()


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU, where the tests drive)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The peak of the device memory the program allocated (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def _window(call, seconds: float, first: int, device):
    """Calls call(first), call(first + 1), ... until `seconds` have passed,
    then synchronises: (calls made, window seconds)."""
    t0 = time.perf_counter()
    i = first
    while time.perf_counter() - t0 < seconds:
        call(i)
        i += 1
    sync(device)
    return i - first, time.perf_counter() - t0


def release(device) -> None:
    """Return the freed program state's memory before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# train: the closed loop of train_step
# ---------------------------------------------------------------------------

class _Schedule:
    """Pool entries in epochs, each a seeded permutation of the pool (the
    trainer's shuffled camera stack): every seed trains on the same images,
    in another order."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.order = n, np.random.default_rng(seed), []

    def __getitem__(self, i: int) -> int:
        while len(self.order) <= i:
            self.order.extend(self.rng.permutation(self.n).tolist())
        return self.order[i]


def train_inputs(cfg: dict, mix: dict, seed: int) -> dict:
    """The training traffic's host inputs: the pool's (camera, frame)
    pairs, every camera in the same share, frames uniform over the
    duration; the schedule; the views a step takes."""
    rng = np.random.default_rng([seed, 1])
    cams = scene.rig_cameras(cfg)
    n = mix["gt_frames"]
    pool_cam = [e % len(cams) for e in range(n)]
    pool_t = rng.integers(0, cfg["frames"], n).astype(float).tolist()
    return {"cams": cams, "pool_cam": pool_cam, "pool_t": pool_t,
            "schedule": _Schedule(n, seed), "spatial_scale": scene.cameras_extent(cfg),
            "views": families.load(cfg).VIEWS_PER_STEP}


def entries(x: dict, i: int) -> list[int]:
    """The pool entries of step i: the schedule's V i .. V i + V - 1, for
    V views a step."""
    v = x["views"]
    return [x["schedule"][v * i + j] for j in range(v)]


def backgrounds(seed: int, n: int, device) -> torch.Tensor:
    """[n, 3] uniform random backgrounds (the config's random_background),
    step i taking row i % n."""
    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0xB6B6)
    return torch.rand((n, 3), generator=g, device=device)


def run_train(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    prog = families.load(cfg).Program(cfg, device)
    x = train_inputs(cfg, mix, seed)
    cams = [prog.camera(c) for c in x["cams"]]
    # The pool: renders of a seeded perturbation of the scene (colours and
    # opacities), held on the device as the trainer's image cache holds
    # frames.
    target = prog.model(scene.make_params(cfg, seed, device, perturb=mix["perturb"]))
    pool = torch.empty((mix["gt_frames"], cfg["height"], cfg["width"], 3), device=device)
    totals = []
    for e in range(mix["gt_frames"]):
        res = prog.render(target, cams[x["pool_cam"][e]], x["pool_t"][e])
        pool[e] = res.render
        totals.append(res.binning_total.clone())
    if int(torch.stack(totals).max()) > prog.capacity:
        raise RuntimeError("a ground-truth render overflowed the capacity")
    del target, res, totals
    carried = prog.start(prog.model(scene.make_params(cfg, seed, device)))
    bgs = backgrounds(seed, mix["backgrounds"], device)
    first_it = mix["first_iteration"]
    totals, flags, dispatch = [], [], []

    def step(i: int, timed: bool = True):
        es = entries(x, i)
        t0 = time.perf_counter()
        loss, total, nan_flag = prog.step(carried, [cams[x["pool_cam"][e]] for e in es],
                                          [pool[e] for e in es], [x["pool_t"][e] for e in es],
                                          bgs[i % len(bgs)], first_it + i)
        if timed:
            dispatch.append(time.perf_counter() - t0)
        # binning_total is a view of the binning's prefix sums: a copy, so
        # that keeping it does not keep them
        totals.append(total.clone())
        flags.append(nan_flag)
        return loss

    def stretch(first: int) -> dict:
        """checked_steps steps from step `first`, through the window's own
        call and feed: the state before and after them, their losses and
        the first moment after the first, on the host."""
        begin = prog.snapshot(carried)
        losses, mu1 = [], None
        for i in range(first, first + mix["checked_steps"]):
            losses.append(float(step(i, timed=False)))
            if mu1 is None:
                mu1 = prog.snapshot(carried)["mu"]
        return {"first": first, "begin": begin, "losses": losses, "mu1": mu1,
                "after": prog.snapshot(carried)}

    # The first steps, which the reference follows, then the warm-up.
    program = {"start": stretch(0)}
    n0 = mix["checked_steps"] + mix["warmup_steps"]
    for i in range(mix["checked_steps"], n0):
        step(i, timed=False)
    totals.clear()
    flags.clear()
    sync(device)
    setup_end = time.perf_counter()
    calls, window_s = _window(step, seconds, n0, device)
    failed = int(((torch.stack(totals) > prog.capacity) | torch.stack(flags)).sum())
    peak = memory_peak(device)
    rec = {"kind": "train", "setup_end": setup_end, "window_s": window_s, "calls": calls,
           "attempted": calls, "failed": failed, "dispatch_s": dispatch,
           "memory_peak_bytes": peak, "profile": None}
    done = n0 + calls
    if traced:
        snaps = []

        def profiled(j):
            i = done + j
            snaps.append((prog.current(carried),
                          [(x["cams"][x["pool_cam"][e]], x["pool_t"][e]) for e in entries(x, i)]))
            step(i, timed=False)

        rec["profile"] = trace.profile_calls(profiled, mix["profiled_calls"], "gsbench.train_step",
                                              device)
        rec["work"] = lambda: _work(cfg, seed, device, snaps)
        done += mix["profiled_calls"]
    # The steps after the window, from the state it left; then the
    # program's state is freed before the reference runs.
    program["window"] = stretch(done)
    del carried, pool, cams
    rec["program"] = program
    rec["check"] = lambda limits: check.train(cfg, mix, seed, device, x, rec["program"],
                                              limits)
    return rec


# ---------------------------------------------------------------------------
# render: the viewer's closed loop
# ---------------------------------------------------------------------------

def run_render(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    prog = families.load(cfg).Program(cfg, device)
    model = prog.model(scene.make_params(cfg, seed, device))
    path = scene.path_cameras(cfg, mix["path_frames"], seed)
    t0_frame = int(np.random.default_rng([seed, 2]).integers(cfg["frames"]))
    rng = np.random.default_rng([seed, 3])
    latencies, dispatch, totals, kept = [], [], [], []
    seen = [0]

    def frame_of(i):
        return path[i % len(path)], float((t0_frame + i) % cfg["frames"])

    def frame(i: int, timed: bool = True, spans=_no_spans):
        c, t = frame_of(i)
        t0 = time.perf_counter()
        with spans("gsbench.camera"):
            cam = prog.camera(c)
        t1 = time.perf_counter()
        with spans("gsbench.render"):
            res = prog.render(model, cam, t)
        t2 = time.perf_counter()
        with spans("gsbench.readback"):
            image = res.render.detach().cpu()
        t3 = time.perf_counter()
        totals.append(res.binning_total.clone())
        if not timed:
            return
        latencies.append(t3 - t0)
        dispatch.append(t2 - t1)
        # a seeded reservoir sample of the delivered frames, for the check
        seen[0] += 1
        if len(kept) < mix["checked_frames"]:
            kept.append((i, image))
        else:
            r = int(rng.integers(seen[0]))
            if r < mix["checked_frames"]:
                kept[r] = (i, image)

    for i in range(mix["warmup_calls"]):
        frame(i, timed=False)
    totals.clear()
    sync(device)
    setup_end = time.perf_counter()
    n0 = mix["warmup_calls"]
    calls, window_s = _window(frame, seconds, n0, device)
    failed = int((torch.stack(totals) > prog.capacity).sum())
    peak = memory_peak(device)
    rec = {"kind": "render", "setup_end": setup_end, "window_s": window_s, "calls": calls,
           "attempted": calls, "failed": failed, "dispatch_s": dispatch,
           "latencies_s": latencies, "memory_peak_bytes": peak, "profile": None}
    if traced:
        from torch.profiler import record_function

        views = []

        def profiled(j):
            i = n0 + calls + j
            views.append((model, [frame_of(i)]))
            frame(i, timed=False, spans=record_function)

        rec["profile"] = trace.profile_calls(profiled, mix["profiled_calls"], "gsbench.frame",
                                              device)
        rec["work"] = lambda: _work(cfg, seed, device, views)
    del model
    sample = [(frame_of(i), check.to_bytes(img)) for i, img in kept]
    rec["sample"] = sample
    rec["check"] = lambda limits: check.render(cfg, seed, device, sample, limits)
    return rec


def _work(cfg: dict, seed: int, device, calls) -> list[dict]:
    """Per profiled call (model, [(camera, t)]), what the yardstick charges:
    the family's census of it (the reference's pair counts, instances and
    visible splats in float32, no gradient; the pixels and active parameter
    elements)."""
    sc = scene.make_params(cfg, seed, device)
    census = families.load(cfg).census
    return [census(cfg, sc, model, views) for model, views in calls]


RUNNERS = {"train": run_train, "render": run_render}


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    return RUNNERS[mix["kind"]](cfg, mix, seed, seconds, traced, device)
