"""The trainer's static-capacity shrink, ex4dgs_tpu_torch against the JAX
package (`Trainer._host_event`: ex4dgs_tpu/train/trainer.py:173-199, the
port's train/trainer.py).

One HostModel (a seeded 5000-point cloud at static capacity 16384 with 16
dynamic splats, seeded moments, stats and optimizer step) is pushed into
both packages' trainers; a `prune_invisible` event then drops the static
rows whose error timestamp is negative:

- to 1000 rows, below a quarter of the capacity: both trainers shrink the
  static capacity to round_capacity(1000) = 4096;
- to 4500 rows, above a quarter: both keep 16384 (a shrink below
  capacity // 4 only).

The capacities, and every pushed parameter, mask, stat and moment row for
row, must be equal exactly (the events and the capacity policy are host
numpy in both packages); after the shrink, the next `train_step` of the
port must match JAX's at tests/test_torch_train.py's tolerances.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_train_step as jts
from ex4dgs_tpu.models import create_from_pcd as jcreate
from ex4dgs_tpu.models import density as JD
from ex4dgs_tpu.models.config import OptimizationConfig as JOpt
from ex4dgs_tpu.train import step as jstep
from ex4dgs_tpu.train.trainer import Trainer as JTrainer
from ex4dgs_tpu_torch.models import density as D
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.train import step as tstep
from ex4dgs_tpu_torch.train.trainer import Trainer
from test_torch_train import _with_dynamic
from torch_parity import as_jax_host, port_camera, port_pull

torch.set_num_threads(2)

N, STATIC_CAP, DYN_CAP, STEP_CAP = 5000, 16384, 64, 16384


def _host(kept: int):
    """(JAX cfg, the port's HostModel): N static points, 16 dynamic, seeded
    optimizer state and stats, and error timestamps that leave `kept`
    static rows (and 12 of the dynamic ones) to prune_invisible."""
    rng = np.random.default_rng(3)
    cfg = jts.ModelConfig(time_interval=5, start_duration=5, duration=10, near=0.2, far=50.0)
    pts = (rng.normal(size=(N, 3)) * 0.8).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(N, 3)).astype(np.float32)
    model = _with_dynamic(cfg, jcreate(pts, cols, cfg, duration=5, static_capacity=STATIC_CAP),
                          dyn_cap=DYN_CAP)
    hm = port_pull(model)
    for k, v in hm.mu.items():
        hm.mu[k] = rng.normal(scale=1e-3, size=v.shape).astype(v.dtype)
        hm.nu[k] = np.abs(rng.normal(scale=1e-3, size=v.shape)).astype(v.dtype)
    for k, v in hm.stats.items():
        hm.stats[k] = rng.uniform(0.0, 3.0, size=v.shape).astype(v.dtype)
    seen = rng.permutation(N) < kept
    hm.stats["xyz_error_min_timestamp"][~seen] = -1.0
    hm.stats["motion_xyz_error_min_timestamp"][12:] = -1.0
    hm.step = 7
    return cfg, hm


def _trainers(cfg, hm):
    """The JAX and the port's Trainer, their model and optimizer state
    pushed from hm at the starting capacities, bare of a scene: what
    `_host_event` reads."""
    jtr = object.__new__(JTrainer)
    jtr.cfg = cfg
    jtr.model, jtr.opt_state = JD.push(as_jax_host(hm), cfg, static_capacity=STATIC_CAP,
                                       dynamic_capacity=DYN_CAP)
    jtr._kf_floor = jtr.model.keyframe_capacity
    tr = object.__new__(Trainer)
    tr.cfg, tr.device, tr.iteration = ModelConfig(**vars(cfg)), torch.device("cpu"), 0
    tr.model, tr.opt_state = D.push(copy.deepcopy(hm), tr.cfg, static_capacity=STATIC_CAP,
                                    dynamic_capacity=DYN_CAP, device="cpu")
    tr._kf_floor = tr.model.keyframe_capacity
    tr.pull_ms, tr.push_ms, tr.event_counts, tr.event_ms, tr.event_log = [], [], {}, {}, []
    return jtr, tr


def _assert_pushed_equal(tr, jtr):
    m, j = tr.model, jtr.model
    assert (m.static_capacity, m.dynamic_capacity, m.keyframe_capacity) == (
        j.static_capacity, j.dynamic_capacity, j.keyframe_capacity)
    for group in ("params", "stats"):
        p, w = getattr(m, group), getattr(j, group)
        assert sorted(p) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(w[k]), err_msg=f"{group} {k}")
    for k in ("static_mask", "dynamic_mask", "keyframe_num", "duration"):
        np.testing.assert_array_equal(getattr(m, k).numpy(), np.asarray(getattr(j, k)),
                                      err_msg=k)
    for group in ("mu", "nu"):
        p, w = getattr(tr.opt_state, group), getattr(jtr.opt_state, group)
        for k in w:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(w[k]), err_msg=f"{group} {k}")
    assert int(tr.opt_state.step) == int(jtr.opt_state.step) == 7


@pytest.mark.parametrize("kept,want_cap", [(1000, 4096), (4500, STATIC_CAP)],
                         ids=["below-a-quarter", "above-a-quarter"])
def test_capacity_shrink_matches_jax(kept, want_cap):
    cfg, hm = _host(kept)
    jtr, tr = _trainers(cfg, hm)
    jtr._host_event(JD.prune_invisible)
    tr._host_event("prune_invisible", D.prune_invisible)
    assert tr.event_log == [(0, "prune_invisible", kept, 12)]
    assert int(tr.model.n_static()) == kept and int(tr.model.n_dynamic()) == 12
    assert tr.model.static_capacity == want_cap
    _assert_pushed_equal(tr, jtr)
    if kept >= STATIC_CAP // 4:
        return
    # the next step on the shrunk model (tests/test_torch_train.py's
    # tolerances of one whole step)
    _, _, cam = jts._scene(n=8)
    gt = np.random.default_rng(5).uniform(size=(jts.H, jts.W, 3)).astype(np.float32)
    js = jstep.StepStatics(cfg=cfg, opt=JOpt(), spatial_lr_scale=1.0, capacity=STEP_CAP,
                           chunk=64, max_per_tile=STEP_CAP)
    ts = tstep.StepStatics(cfg=tr.cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                           capacity=STEP_CAP)
    want = jstep.train_step(jtr.model, jtr.opt_state, cam, jnp.asarray(gt), jnp.asarray(1.0),
                            jnp.zeros(3), jnp.asarray(100, jnp.int32), js)
    got = tstep.train_step(tr.model, tr.opt_state, port_camera(cam), torch.tensor(gt), 1.0,
                           torch.zeros(3), 100, ts, device="cpu")
    assert int(got.binning_total) == int(want.binning_total) <= STEP_CAP
    for k in want.model.params:
        old = tr.model.params[k].numpy()
        for what, g, w in (("update", got.model.params[k].numpy() - old,
                            np.asarray(want.model.params[k]) - old),
                           ("mu", got.opt_state.mu[k].numpy(), np.asarray(want.opt_state.mu[k])),
                           ("nu", got.opt_state.nu[k].numpy(), np.asarray(want.opt_state.nu[k]))):
            atol = 1e-5 * np.abs(w).max() if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=f"{k} {what}")
        np.testing.assert_allclose(got.model.params[k].numpy(), np.asarray(want.model.params[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert int(got.opt_state.step) == int(want.opt_state.step) == 8
    for k in want.model.stats:
        np.testing.assert_allclose(got.model.stats[k].numpy(), np.asarray(want.model.stats[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    np.testing.assert_allclose([float(got.loss), float(got.ll1), float(got.psnr)],
                               [float(want.loss), float(want.ll1), float(want.psnr)],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.visibility.numpy(), np.asarray(want.visibility))
