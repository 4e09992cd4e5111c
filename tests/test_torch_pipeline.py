"""The port's one-step training pipeline (EX4DGS_PIPELINE) and the host
reads it needs gone, against the JAX package.

- The pipelined loop against the serial one (EX4DGS_PIPELINE=0) on
  tests/test_trainer.py::test_trainer_pipeline_matches_serial's scene and
  schedule (cut to 45 iterations), through its density events, without an
  overflow: the steps' cameras, every loss, event, parameter and stat
  bit-equal.
- A forced overflow (starting capacity 256): the port's pipelined trainer
  against JAX's pipelined trainer from one seed on
  tests/test_torch_trainer_jax.py's textured scene: the order in which
  the steps ran their cameras (the port swaps the overflowed step with
  the one dispatched after it; JAX's relaunch runs the later one twice,
  see the test), the first attempts' losses at that file's rtol 1e-5,
  the step and overflow counts and the capacity. Then every attempt of
  the port against JAX's `train_step` run in the port's order, on the
  same cameras, frames, timestamps, backgrounds and capacities: each
  loss at rtol 1e-5, the parameters after the last step at
  tests/test_torch_train.py's atol 1e-6 and the stats at that atol and
  rtol 1e-5.
- `_events_due` (a dry run of `_scheduled_events`) equal to JAX's
  predicate at every iteration of the shortened schedule of chip_smoke's
  phase 12, under every state of the flags it reads; a dry run changes
  nothing.
- The keyframe index, computed on the host, equal to JAX's over a sweep of
  timestamps: exact multiples of the interval, timestamps shifted by
  time_shift onto them, their float32 neighbours, and timestamps past the
  last keyframe, where the query reads NaN in both packages.
- The sharded step's device gate: on an overflow at mesh (1, 1) the input
  model and state come back bit for bit, as train_step's do.

That the step path makes no host read is checked on the card:
tests/test_torch_sync.py and chip_smoke.py phase 8.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pipeline.py
"""
import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu import synthetic as jsyn
from ex4dgs_tpu.models import temporal as jtemp
from ex4dgs_tpu.models.config import ModelConfig as JModelConfig
from ex4dgs_tpu.ops import interpolation as jint
from ex4dgs_tpu.train.trainer import Trainer as JTrainer
from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.optimizer import init_state
from ex4dgs_tpu_torch.models import temporal as ttemp
from ex4dgs_tpu_torch.ops import interpolation as tint
from ex4dgs_tpu_torch.parallel import make_mesh
from ex4dgs_tpu_torch.parallel.step_dp import make_sharded_train_step
from ex4dgs_tpu_torch.train import step as tstep
from ex4dgs_tpu_torch.train import trainer as trainer_mod
from test_torch_trainer import SCENE, _trainer, disk_scene  # noqa: F401 (fixture)
from torch_parity import as_np, port_model

torch.set_num_threads(2)


def _train(root, pipeline: str, monkeypatch, opt_kw, **kw):
    """A port Trainer on `root` trained with EX4DGS_PIPELINE=pipeline; its
    metrics, the (iteration, timestamp, loss, capacity, background) of
    every train_step it ran, and the trainer."""
    monkeypatch.setenv("EX4DGS_PIPELINE", pipeline)
    calls, step = [], trainer_mod.train_step

    def recording(model, opt_state, cam, gt, t, bg, it, statics, **k):
        out = step(model, opt_state, cam, gt, t, bg, it, statics, **k)
        calls.append((int(it), float(t), float(out.loss), statics.capacity,
                      tuple(bg.tolist())))
        return out

    monkeypatch.setattr(trainer_mod, "train_step", recording)
    tr = _trainer(root, opt_kw, **kw)
    metrics = tr.train(iterations=opt_kw["iterations"])
    tr.close()
    monkeypatch.undo()
    return metrics, calls, tr


# tests/test_trainer.py::test_trainer_pipeline_matches_serial's schedule, cut to
# 45 iterations (densification at 25, an interval extraction at 40, a
# marked one after 35)
SERIAL_SCHEDULE = dict(iterations=45, densification_interval=25, densify_from_iter=10,
                       extract_from_iter=10, densify_until_iter=1000,
                       progressive_growing_steps=30, make_dynamic_interval=5,
                       extracton_interval=40, prune_invisible_interval=100000,
                       random_background=False)


def test_pipelined_loop_matches_serial(disk_scene, monkeypatch):
    """No overflow: the pipelined loop (the default) trains exactly as the
    serial one, through its density events (the drains keep their order)."""
    m_p, calls_p, tr_p = _train(disk_scene, "1", monkeypatch, SERIAL_SCHEDULE,
                                capacity=65536, seed=11)
    m_s, calls_s, tr_s = _train(disk_scene, "0", monkeypatch, SERIAL_SCHEDULE,
                                capacity=65536, seed=11)
    assert m_p["pipeline"] is True and m_s["pipeline"] is False
    assert tr_p.overflow_count == tr_s.overflow_count == 0
    assert calls_p == calls_s and len(calls_p) == 45
    assert tr_p.event_log == tr_s.event_log and len(tr_p.event_log) > 3
    assert m_p["event_iterations"] == m_s["event_iterations"]
    assert m_p["loss"] == m_s["loss"] and m_p["psnr"] == m_s["psnr"]
    assert tr_p.error_tracker.errors == tr_s.error_tracker.errors
    for k, v in tr_p.model.params.items():
        assert torch.equal(v, tr_s.model.params[k]), k
    for k, v in tr_p.model.stats.items():
        assert torch.equal(v, tr_s.model.stats[k]), k


@pytest.fixture(scope="module")
def textured_scene(tmp_path_factory):
    return write_n3v_scene(str(tmp_path_factory.mktemp("textured")), n_cams=4, n_frames=6,
                           n_points=300, width=640, height=480, seed=1)


OVERFLOW_ITERS = 6
OVERFLOW_SCHEDULE = dict(iterations=OVERFLOW_ITERS, densification_interval=20,
                         densify_from_iter=10, extract_from_iter=20, densify_until_iter=1000,
                         progressive_growing_steps=40, make_dynamic_interval=10,
                         extracton_interval=60, prune_invisible_interval=100000,
                         random_background=True)


def test_pipelined_overflow_matches_jax_pipeline(textured_scene, monkeypatch):
    """From capacity 256 the first two steps overflow (the second is
    dispatched before the first is read). The port re-runs each at a grown
    capacity after the step dispatched behind it: steps (1, 2, 1, 3, 2, 4,
    ...), the swap the JAX trainer's docstring describes. JAX's loop runs
    (1, 2, 2, 3, 3, 4, ...) instead: its relaunch, `lambda:
    run(self._statics())`, looks `run` up when it is called, by which time
    the name holds the next iteration's step, so the overflowed camera is
    dropped and the next one runs twice (a fault of the JAX package, which
    stays as it is). Held to JAX's trainer: the first two attempts
    (cameras, and losses at tests/test_torch_trainer_jax.py's rtol 1e-5),
    every iteration's background, the step and overflow counts and the
    grown capacity; the orders are pinned as above. Then JAX's train_step
    replays the port's attempts in the port's order, each on the model and
    state the one before it returned, at the capacity it ran at, on the
    camera, frame, timestamp and background JAX's trainer gave that
    iteration: every attempt's loss at rtol 1e-5, the parameters after the
    last at tests/test_torch_train.py's atol 1e-6 (the updates of these
    steps are 1e-5 to 1e-3, so a step on the wrong model or state breaks
    it), and the stats, sums over six steps, at that atol and the
    trajectory's rtol 1e-5 (they differ by up to 3.2e-6 relative)."""
    import dataclasses

    from ex4dgs_tpu.data.readers import read_n3v_scene as jread
    from ex4dgs_tpu.data.scene import Scene as JScene
    from ex4dgs_tpu.models import OptimizationConfig as JOpt
    from ex4dgs_tpu.train import trainer as jtrainer_mod

    monkeypatch.setenv("EX4DGS_PIPELINE", "1")
    jcalls, jstep = [], jtrainer_mod.train_step

    def jrecording(model, opt_state, cam, gt, t, bg, it, statics):
        out = jstep(model, opt_state, cam, gt, t, bg, it, statics)
        jcalls.append((int(it), float(t), float(out.loss), (cam, gt, t, bg, statics)))
        return out

    monkeypatch.setattr(jtrainer_mod, "train_step", jrecording)
    jcfg = JModelConfig(**{**SCENE, "source_path": textured_scene})
    jtr = JTrainer(jcfg, JOpt(**OVERFLOW_SCHEDULE),
                   JScene(jcfg, scene_info=jread(textured_scene, jcfg)), capacity=256,
                   max_per_tile=512, seed=11)
    model0, state0 = jtr.model, jtr.opt_state
    jtr.train(iterations=OVERFLOW_ITERS)
    monkeypatch.undo()

    got, calls, tr = _train(textured_scene, "1", monkeypatch, OVERFLOW_SCHEDULE,
                            capacity=256, seed=11)
    order, jorder = [c[:2] for c in calls], [c[:2] for c in jcalls]
    firsts = [order[i] for i in (0, 1, 3, 5, 6, 7)]  # each iteration's first attempt
    assert [it for it, _ in firsts] == list(range(1, OVERFLOW_ITERS + 1))
    assert order == [firsts[i] for i in (0, 1, 0, 2, 1, 3, 4, 5)]
    assert jorder == [firsts[i] for i in (0, 1, 1, 2, 2, 3, 4, 5)]
    np.testing.assert_allclose([x[2] for x in calls[:2]], [x[2] for x in jcalls[:2]],
                               rtol=1e-5, atol=0)
    assert got["loss"][0] == calls[2][2]
    assert tr.steps == len(calls) == len(jcalls) == OVERFLOW_ITERS + tr.overflow_count
    assert tr.overflow_count == jtr.overflow_count == 2
    assert tr.capacity == jtr.capacity > 65536
    assert np.isfinite(got["loss"]).all() and len(got["loss"]) == OVERFLOW_ITERS

    # JAX's step in the port's order: each iteration's inputs as JAX's
    # trainer made them (its first call of the iteration), chained.
    inputs = {}
    for it, _, _, ins in jcalls:
        inputs.setdefault(it, ins)
    model, state, replay = model0, state0, []
    for it, t, _, cap, bg in calls:
        cam, gt, t_dev, jbg, statics = inputs[it]
        assert float(t_dev) == t and tuple(np.asarray(jbg).tolist()) == bg, it
        out = jstep(model, state, cam, gt, t_dev, jbg, jnp.asarray(it, jnp.int32),
                    dataclasses.replace(statics, capacity=cap))
        model, state = out.model, out.opt_state
        replay.append(float(out.loss))
    assert [c[3] for c in calls[:2]] == [256, 256] and min(c[3] for c in calls[2:]) > 256
    np.testing.assert_allclose([c[2] for c in calls], replay, rtol=1e-5, atol=0)
    assert int(tr.opt_state.step) == int(state.step) == OVERFLOW_ITERS
    for k, w in model.params.items():
        np.testing.assert_allclose(tr.model.params[k].numpy(), np.asarray(w), atol=1e-6, rtol=0,
                                   err_msg=k)
    for k, w in model.stats.items():
        np.testing.assert_allclose(tr.model.stats[k].numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


# chip_smoke.py's TRAIN_SCHEDULE (phase 12), with iterations past the
# prune_invisible gate (3000)
DUE_SCHEDULE = dict(iterations=3300, densify_from_iter=20, densification_interval=30,
                    extract_from_iter=20, progressive_growing_steps=40,
                    make_dynamic_interval=10, extracton_interval=60,
                    densify_until_iter=3100, random_background=False)


def test_events_due_matches_jax(disk_scene):
    """The port's predicate is JAX's, case for case, at every iteration and
    in every state of the flags it reads; a dry run changes nothing."""
    tr = _trainer(disk_scene, DUE_SCHEDULE, capacity=65536)
    cam = tr.scene.train_cameras[0]
    jopt = types.SimpleNamespace(**{k: getattr(tr.opt, k) for k in vars(tr.opt)})
    fields = ("mark_last", "mark_extract", "need_extract", "prune_inv", "e_count",
              "sample_len", "last_cam")
    n_due = 0
    for prune_inv, mark_extract, has_cam in itertools.product((False, True), repeat=3):
        tr.prune_inv, tr.mark_extract = prune_inv, mark_extract
        tr.last_cam = cam if has_cam else None
        jself = types.SimpleNamespace(opt=jopt, prune_inv=prune_inv, mark_extract=mark_extract)
        if has_cam:
            jself.last_cam = cam
        before = ({f: getattr(tr, f) for f in fields}, dict(tr.error_tracker.errors),
                  list(tr.event_log), tr.scene.sample_len)
        for it in range(1, DUE_SCHEDULE["iterations"] + 1):
            due = tr._events_due(it)
            assert due == JTrainer._events_due(jself, it), (it, prune_inv, mark_extract,
                                                            has_cam)
            n_due += due
        after = ({f: getattr(tr, f) for f in fields}, dict(tr.error_tracker.errors),
                 list(tr.event_log), tr.scene.sample_len)
        assert after == before
    tr.close()
    assert n_due > 8 * 100


def _timestamps(interval: float, shift: float, n_kf: int) -> np.ndarray:
    """Multiples of the interval, shifted onto them, their float32
    neighbours, and seeded timestamps out to past the last keyframe."""
    base = np.arange(-2, n_kf + 4, dtype=np.float32) * np.float32(interval)
    ts = np.concatenate([base, base - np.float32(shift)])
    ts = np.concatenate([ts, np.nextafter(ts, np.float32(np.inf)),
                         np.nextafter(ts, np.float32(-np.inf))])
    rng = np.random.default_rng(5)
    extra = rng.uniform(-interval, (n_kf + 3) * interval, 200).astype(np.float32)
    ts = np.concatenate([ts, extra]).astype(np.float32)
    # Subnormal neighbours of 0 left out: XLA's CPU flushes them to zero,
    # numpy and PyTorch do not.
    return ts[(ts == 0) | (np.abs(ts) >= np.finfo(np.float32).tiny)]


@pytest.mark.parametrize("interval,shift", [(2, 1), (5, 8), (5, 3), (3.3, 2.5), (0.7, 0)])
def test_keyframe_index_matches_jax(interval, shift):
    for t in _timestamps(interval, shift, 12):
        k_j = int(jint.keyframe_coords(jnp.asarray(t, jnp.float32), shift, interval)[0])
        k_t, dt_t = tint.keyframe_coords(torch.tensor(t), shift, interval, t_host=float(t))
        assert k_t == k_j == tint.keyframe_index(t, shift, interval), t
        assert tint.keyframe_coords(torch.tensor(t), shift, interval)[0] == k_j, t


@pytest.mark.parametrize("t", [0.0, 10.0, 12.5, 97.25])
def test_point_data_past_the_keyframes_matches_jax(t):
    """The query through point_data_at_t with a host timestamp, out to past
    the last keyframe, where the dynamic rows read NaN in both."""
    cfg = JModelConfig(time_interval=5, start_duration=5, duration=10, near=0.2, far=100.0)
    jm, jc = jsyn.make_scene(n_static=40, n_dynamic=12, duration=10.0, seed=4, cfg=cfg,
                             static_capacity=64, dynamic_capacity=16)
    tm, tc = port_model(jm), ModelConfig(**vars(jc))
    pj = jtemp.point_data_at_t(jm, jc, jnp.asarray(t, jnp.float32), mode=0)
    pt = ttemp.point_data_at_t(tm, tc, t, mode=0)
    for name in ("means3d", "rotations", "opacity"):
        got, want = as_np(getattr(pt, name)), np.asarray(getattr(pj, name))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
    if t > 20:
        assert np.isnan(as_np(pt.means3d)[64:]).all()


def test_sharded_step_overflow_returns_inputs():
    """At mesh (1, 1) a step whose binning overflows returns its input
    model and state bit for bit (the gate on the device), as train_step
    does, with the same instance count."""
    from test_torch_train import _port, _scene

    cfg, model, cam, _ = _scene(True)
    tc, tm, tcam = _port(cfg, model, cam)
    statics = tstep.StepStatics(cfg=tc, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                                capacity=128)
    state = init_state(tm.params, device="cpu")
    gt = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(tcam.height, tcam.width, 3)).astype(np.float32))
    args = (tm, state, tcam, gt, 1.0, torch.zeros(3), 700)
    out = make_sharded_train_step(statics, make_mesh(device="cpu"), device="cpu")(*args)
    ref = tstep.train_step(*args, statics, device="cpu")
    assert int(out.binning_total) == int(ref.binning_total) > statics.capacity
    for name in ("params", "stats"):
        for k, v in getattr(tm, name).items():
            assert torch.equal(getattr(out.model, name)[k], v), k
            assert torch.equal(getattr(ref.model, name)[k], v), k
    for k in tm.params:
        assert torch.equal(out.opt_state.mu[k], state.mu[k]), k
        assert torch.equal(out.opt_state.nu[k], state.nu[k]), k
    assert torch.equal(out.opt_state.step, state.step) and not bool(out.nan_flag)
