"""ex4dgs_tpu_torch's Trainer and training CLI on on-disk N3V scenes.

The cases of tests/test_trainer.py on the port (its multi-device case is
tests/test_torch_trainer_mesh.py; its pipelined-against-serial case is
tests/test_torch_pipeline.py; tests/test_torch_trainer_jax.py holds the
port to a serial JAX trainer):

- the schedule runs every event kind it reaches, learns, and stays
  healthy (after events only health and learning are checked: density
  thresholds flip on ulp differences, so no two implementations agree
  there array for array);
- progressive growth never reshapes the keyframe arrays;
- a forced overflow (starting capacity 256) grows the capacity and re-runs
  the same camera on the unchanged state;
- the CLI trains, saves the reference-layout PLY and checkpoint, reloads the
  checkpoint bit-equal and resumes from it.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch.data.readers import read_n3v_scene
from ex4dgs_tpu_torch.data.scene import ImagePrefetcher, Scene
from ex4dgs_tpu_torch.io.checkpoint import digest, load_checkpoint
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.density import pull, push
from ex4dgs_tpu_torch.models.state import required_keyframes
from ex4dgs_tpu_torch.train import __main__ as cli
from ex4dgs_tpu_torch.train.trainer import Trainer
from test_data_io import _write_colmap_model, _write_frames

torch.set_num_threads(2)

# tests/test_trainer.py's scene and schedule
SCENE = dict(loader="neural3dvideo", resolution=8, duration=-1, time_interval=2, time_pad=1,
             start_duration=2, near=0.05, far=50.0)
SCHEDULE = dict(densification_interval=30, densify_from_iter=20, extract_from_iter=20,
                densify_until_iter=1000, progressive_growing_steps=40, make_dynamic_interval=10,
                extracton_interval=60, prune_invisible_interval=100000, random_background=False)


@pytest.fixture(scope="module")
def disk_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    _write_colmap_model(os.path.join(root, "colmap_0", "sparse", "0"), n_cams=4, n_pts=300)
    _write_frames(root, n_cams=4, n_frames=6)
    return root


def _trainer(root, opt_kw, scene_kw=None, **kw):
    cfg = ModelConfig(source_path=root, **{**SCENE, **(scene_kw or {})})
    opt = OptimizationConfig(**{**SCHEDULE, **opt_kw})
    scene = Scene(cfg, scene_info=read_n3v_scene(root, cfg))
    return Trainer(cfg, opt, scene, device="cpu", **kw)


@pytest.fixture(scope="module")
def schedule_run(disk_scene):
    """tests/test_trainer.py's schedule for 90 iterations (densify at 30, 60
    and 90, extraction after 50 and 80, progressive growth at 80), at
    resolution 16: (trainer, metrics, keyframe capacity before training)."""
    tr = _trainer(disk_scene, dict(iterations=120), dict(resolution=16), capacity=65536)
    kc0 = tr.model.keyframe_capacity
    metrics = tr.train(iterations=90)
    yield tr, metrics, kc0
    tr.close()


def test_trainer_runs_schedule(schedule_run, disk_scene, tmp_path):
    tr, metrics, _ = schedule_run
    losses = np.asarray(metrics["loss"])
    assert losses.shape == (90,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()  # learning
    assert int(tr.model.n_static()) > 0 and int(tr.model.n_dynamic()) > 0
    assert tr.sample_len >= tr.cfg.start_duration
    # every scheduled kind ran when the schedule says; an extraction follows
    # the first camera of the sampling window's last interval after the
    # marks at 50 and 80
    log = [e[:2] for e in tr.event_log]
    assert log[0] == (0, "expand_duration")  # the trainer's own, at construction
    assert [it for it, k in log if k == "densify_and_prune"] == [30, 60, 90]
    assert [it for it, k in log if k == "expand_duration"] == [0, 80]
    ext = [it for it, k in log if k == "extract_dynamic_from_static"]
    assert len(ext) == 2 and 50 < ext[0] < 60 and 80 < ext[1] <= 90, ext
    assert sorted(tr.event_counts) == ["densify_and_prune", "expand_duration",
                                       "extract_dynamic_from_static"]
    assert metrics["event_iterations"] == sorted({it for it, _ in log[1:]})
    assert tr.steps == 90 and tr.overflow_count == 0
    assert len(tr.pull_ms) == len(tr.push_ms) == len(tr.event_log)

    mp = str(tmp_path / "out")
    saved = tr.save(mp)
    it = tr.iteration
    assert os.path.exists(os.path.join(mp, "point_cloud", f"iteration_{it}", "point_cloud.ply"))
    assert os.path.exists(os.path.join(mp, "point_cloud", f"iteration_{it}",
                                       "dynamic_point_cloud.ply"))
    hm, saved_it, extra = load_checkpoint(os.path.join(mp, f"chkpnt{it}.npz"))
    assert saved_it == it and digest(hm) == digest(saved)
    model2, state2 = push(hm, tr.cfg, device="cpu")
    assert digest(pull(model2, state2)) == digest(saved)
    t2 = Trainer(tr.cfg, tr.opt, tr.scene, model=model2, opt_state=state2, capacity=65536,
                 device="cpu")
    t2.iteration = saved_it
    t2.sample_len = float(extra["sample_len"])
    m2 = t2.train(iterations=saved_it + 10)
    t2.close()
    assert len(m2["loss"]) == 10 and np.isfinite(m2["loss"]).all()
    assert int(t2.opt_state.step) == int(tr.opt_state.step) + 10


def test_trainer_preallocates_keyframes(schedule_run):
    """Progressive growth (at 80) never reshapes the motion arrays: keyframe
    capacity covers the whole scene from the start, as the JAX trainer
    sizes it, so checkpoints compare row for row."""
    tr, _, kc0 = schedule_run
    assert kc0 >= required_keyframes(tr.scene.duration + tr.cfg.time_shift, tr.cfg)
    assert tr.model.keyframe_capacity == kc0
    assert tr.sample_len > tr.cfg.start_duration  # growth ran
    assert int(tr.model.keyframe_num) > 0


class _Recording(ImagePrefetcher):
    """The port's prefetcher, recording the frames it hands out."""

    def __init__(self, seen, **kw):
        super().__init__(**kw)
        self.seen = seen

    def epoch(self, cameras, shuffle=True, rng=None):
        for cam, img in super().epoch(cameras, shuffle=shuffle, rng=rng):
            self.seen.append(cam.image_path)
            yield cam, img


def _record(trainer, seen):
    trainer.prefetcher.close()
    trainer.prefetcher = _Recording(seen, device="cpu")


def test_trainer_overflow_retry(disk_scene):
    """Starting from an undersized instance buffer, the trainer detects the
    overflow, grows the capacity and re-runs the same camera on the
    unchanged state: its first loss equals that of a trainer that never
    overflowed, and no step was applied twice."""
    runs = {}
    for cap in (256, 65536):
        tr = _trainer(disk_scene, dict(iterations=3, densify_from_iter=1000,
                                       extract_from_iter=1000,
                                       progressive_growing_steps=1000), capacity=cap)
        seen = []
        _record(tr, seen)
        metrics = tr.train(iterations=3)
        runs[cap] = (tr, metrics, seen)
        tr.close()
    tr, metrics, seen = runs[256]
    assert tr.overflow_count >= 1 and tr.capacity > 256
    assert tr.steps == 3 + tr.overflow_count and len(seen) == 3  # no camera drawn twice
    assert int(tr.opt_state.step) == 3
    ref, ref_metrics, ref_seen = runs[65536]
    assert ref.overflow_count == 0 and seen == ref_seen
    np.testing.assert_array_equal(metrics["loss"][0], ref_metrics["loss"][0])
    assert np.isfinite(metrics["loss"]).all()
    for k, v in tr.model.params.items():
        assert bool(torch.isfinite(v).all()), k


def test_cli_trains_saves_and_resumes(disk_scene, tmp_path):
    """python -m ex4dgs_tpu_torch.train on the CPU: trains, saves the
    reference-layout files at each save iteration, writes its report, and
    resumes from the checkpoint it wrote, which reloads bit-equal."""
    out = str(tmp_path / "model")
    base = ["--source_path", disk_scene, "--model_path", out, "--device", "cpu", "--quiet",
            "--resolution", "16", "--time_interval", "2", "--time_pad", "1",
            "--start_duration", "2", "--near", "0.05", "--far", "50", "--duration", "-1",
            "--densify_from_iter", "2", "--densification_interval", "3",
            "--random_background", "true"]
    assert cli.main(base + ["--iterations", "4", "--save_iterations", "2",
                            "--test_iterations", "4"]) == 0
    for it in (2, 4):
        assert os.path.exists(os.path.join(out, "point_cloud", f"iteration_{it}",
                                           "point_cloud.ply"))
        assert os.path.exists(os.path.join(out, f"chkpnt{it}.npz"))
    with open(os.path.join(out, "train_report.json")) as f:
        report = json.load(f)
    assert report["iterations"] == [1, 4] and len(report["loss"]) == 4
    assert all(math.isfinite(x) for x in report["loss"])
    assert report["event_counts"]["densify_and_prune"] == 1  # at 3
    assert report["event_iterations"] == [3]
    assert report["test_renders"] == report["test_reports"][0][1]["n_frames"] > 0
    assert report["kernel_launches"]["composite_fwd"] == 0  # the CPU runs the plain versions
    hm, it, _ = load_checkpoint(os.path.join(out, "chkpnt4.npz"))
    assert it == 4 and digest(hm) == report["saved"]["4"]
    with open(os.path.join(out, "cfg_args.json")) as f:
        assert json.load(f)["time_interval"] == 2

    assert cli.main(base + ["--iterations", "6", "--start_checkpoint",
                            os.path.join(out, "chkpnt4.npz")]) == 0
    with open(os.path.join(out, "train_report.json")) as f:
        resumed = json.load(f)
    assert resumed["iterations"] == [5, 6] and all(math.isfinite(x) for x in resumed["loss"])
    hm6, it6, _ = load_checkpoint(os.path.join(out, "chkpnt6.npz"))
    assert it6 == 6 and hm6.step == hm.step + 2
