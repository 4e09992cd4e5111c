"""ex4dgs_tpu_torch's Trainer and training CLI on a (data, gauss) mesh of
gloo ranks, on the CPU (tests/test_trainer.py's sharded-mesh case on the
port; the ranks are tests/test_torch_parallel.py's `spawn_ranks`).

- The Trainer at mesh (2, 2) on tests/test_trainer.py's scene and schedule
  trains 40 iterations through densification, extraction and growth
  events: finite losses that fall (test_trainer_sharded_mesh's bound), and
  the four ranks' models bit-equal (digests).
- The Trainer at mesh (2, 1) against JAX's Trainer(mesh=) on the same
  mesh (its 8 virtual CPU devices; at gauss 1 JAX's gradients are the
  single step's, tests/test_torch_parallel_step.py), one seed and one
  textured on-disk scene (tests/test_torch_trainer_jax.py's), from an
  instance buffer that overflows at the first step, through epoch ends
  (padded batches) to the first density event: the batch cameras and
  timestamps of every step and the backgrounds exactly, the overflow
  count and the grown capacity, every loss and PSNR at
  tests/test_torch_trainer_jax.py's rtol 1e-5, the error tracker's windows
  (counts exactly, sums at that rtol), and the parameters after the event
  at tests/test_torch_train.py's one-step tolerance. Both trainers run
  serially (EX4DGS_PIPELINE=0): pipelined, JAX's overflow retry re-runs
  the step dispatched after the overflowed one (tests/test_torch_pipeline.py).
- The port's Trainer at mesh (2, 1) pipelined against serial, without an
  overflow (the same steps and bits), and pipelined from the overflowing
  capacity (the first step re-run after the second), every rank alike.
- The CLI with --mesh_data 2 --coordinator <file store> --num_processes 2
  --process_id r --dist_backend gloo: rank 0 alone writes the model path's
  files, the report carries both ranks' checkpoint digests, equal, and the
  checkpoint reloads to them.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_trainer_mesh.py
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch.data.readers import read_n3v_scene
from ex4dgs_tpu_torch.data.scene import Scene
from ex4dgs_tpu_torch.io.checkpoint import digest, load_checkpoint
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.density import pull
from ex4dgs_tpu_torch.parallel import make_mesh
from ex4dgs_tpu_torch.train import __main__ as cli
from ex4dgs_tpu_torch.train.trainer import Trainer
from test_torch_parallel import spawn_ranks, store_url

torch.set_num_threads(2)

# tests/test_trainer.py's scene and its sharded-mesh schedule
SCENE = dict(loader="neural3dvideo", resolution=8, duration=-1, time_interval=2, time_pad=1,
             start_duration=2, near=0.05, far=50.0)
SCHEDULE = dict(iterations=40, densification_interval=15, densify_from_iter=10,
                extract_from_iter=10, densify_until_iter=1000, progressive_growing_steps=20,
                make_dynamic_interval=5, extracton_interval=30,
                prune_invisible_interval=100000, random_background=False)


@pytest.fixture(scope="module")
def disk_scene(tmp_path_factory):
    from test_data_io import _write_colmap_model, _write_frames

    root = str(tmp_path_factory.mktemp("scene"))
    _write_colmap_model(os.path.join(root, "colmap_0", "sparse", "0"), n_cams=4, n_pts=300)
    _write_frames(root, n_cams=4, n_frames=6)
    return root


def _trainer_rank(rank, world, root):
    cfg = ModelConfig(source_path=root, **SCENE)
    scene = Scene(cfg, scene_info=read_n3v_scene(root, cfg))
    mesh = make_mesh(world, data=2, gauss=2, device="cpu")
    tr = Trainer(cfg, OptimizationConfig(**SCHEDULE), scene, capacity=66560, device="cpu",
                 mesh=mesh)
    metrics = tr.train(iterations=40)
    hm = pull(tr.model, tr.opt_state)
    tr.close()
    return dict(loss=metrics["loss"], digest=digest(hm), events=dict(tr.event_counts),
                finite=all(bool(np.isfinite(v).all()) for v in hm.params.values()),
                steps=tr.steps, n_dynamic=hm.params["motion_xyz"].shape[0])


def test_trainer_sharded_mesh(disk_scene, tmp_path):
    outs = spawn_ranks(_trainer_rank, 4, tmp_path, disk_scene)
    assert len({o["digest"] for o in outs}) == 1  # the ranks stayed bit-equal
    out = outs[0]
    losses = np.asarray(out["loss"])
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean() * 1.5
    assert out["finite"] and out["steps"] >= 40
    assert out["events"]["densify_and_prune"] >= 2  # at 15 and 30
    assert out["events"]["expand_duration"] >= 2


# tests/test_torch_trainer_jax.py's run: test_torch_trainer.py's schedule
# with the first density event at N
N = 20
JAX_SCHEDULE = dict(iterations=120, densification_interval=20, densify_from_iter=10,
                    extract_from_iter=20, densify_until_iter=1000, progressive_growing_steps=40,
                    make_dynamic_interval=10, extracton_interval=60,
                    prune_invisible_interval=100000, random_background=True)
SMALL_CAPACITY = 256  # overflows at the first step


@pytest.fixture(scope="module")
def textured_scene(tmp_path_factory):
    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene

    return write_n3v_scene(str(tmp_path_factory.mktemp("textured")), n_cams=4, n_frames=6,
                           n_points=300, width=640, height=480, seed=1)


def _jax_mesh_run(root):
    """JAX's serial Trainer at mesh (2, 1): its metrics, the batch of every
    step it ran ([data] timestamps and view matrices, retries included)
    and the trainer."""
    import jax.numpy as jnp

    from ex4dgs_tpu.data.readers import read_n3v_scene as jread
    from ex4dgs_tpu.data.scene import Scene as JScene
    from ex4dgs_tpu.models import ModelConfig as JModelConfig
    from ex4dgs_tpu.models import OptimizationConfig as JOpt
    from ex4dgs_tpu.parallel.mesh import make_mesh as j_mesh
    from ex4dgs_tpu.train.trainer import Trainer as JTrainer

    mp = pytest.MonkeyPatch()
    mp.setenv("EX4DGS_PIPELINE", "0")
    try:
        cfg = JModelConfig(source_path=root, **SCENE)
        tr = JTrainer(cfg, JOpt(**JAX_SCHEDULE), JScene(cfg, scene_info=jread(root, cfg)),
                      capacity=SMALL_CAPACITY, max_per_tile=512, seed=11,
                      mesh=j_mesh(2, data=2, gauss=1))
        batches, get = [], tr._get_sharded_step

        def recording(statics):
            step = get(statics)

            def run(model, opt_state, cams, gts, ts, bg, it):
                batches.append((int(it), np.asarray(ts), np.asarray(cams.view), np.asarray(bg)))
                return step(model, opt_state, cams, gts, ts, bg, it)

            return run

        tr._get_sharded_step = recording
        metrics = tr.train(iterations=N)
    finally:
        mp.undo()
    return metrics, batches, tr


def _port_mesh_rank(rank, world, root, pipeline="0", capacity=SMALL_CAPACITY):
    """The port's Trainer at mesh (2, 1) on one rank, serial or pipelined
    (EX4DGS_PIPELINE): its metrics, the camera of every step it ran
    (retries included), and its end state."""
    os.environ["EX4DGS_PIPELINE"] = pipeline
    cfg = ModelConfig(source_path=root, **SCENE)
    scene = Scene(cfg, scene_info=read_n3v_scene(root, cfg))
    tr = Trainer(cfg, OptimizationConfig(**JAX_SCHEDULE), scene, capacity=capacity,
                 seed=11, device="cpu", mesh=make_mesh(world, data=2, gauss=1, device="cpu"))
    steps, step = [], tr._step

    def recording(cam, gt, timestamp, bg, it):
        steps.append((it, float(timestamp), cam.view.numpy().copy(), bg.numpy().copy()))
        return step(cam, gt, timestamp, bg, it)

    tr._step = recording
    metrics = tr.train(iterations=N)
    hm = pull(tr.model, tr.opt_state)
    tr.close()
    return dict(loss=metrics["loss"], psnr=metrics["psnr"], steps=steps, params=hm.params,
                digest=digest(hm), capacity=tr.capacity, overflow=tr.overflow_count,
                errors=dict(tr.error_tracker.errors), events=[e[:2] for e in tr.event_log])


def _port_mesh_pipeline_rank(rank, world, root):
    """The port's Trainer at mesh (2, 1) on one rank, pipelined and serial
    at a capacity that never overflows, then pipelined from SMALL_CAPACITY."""
    runs = {}
    for name, pipeline, cap in (("pipelined", "1", 65536), ("serial", "0", 65536),
                                ("overflow", "1", SMALL_CAPACITY)):
        runs[name] = _port_mesh_rank(rank, world, root, pipeline, cap)
    return runs


def test_trainer_mesh_pipelined_matches_serial(textured_scene, tmp_path):
    """The mesh path pipelines as the single-card loop does: without an
    overflow the pipelined and serial loops train the same steps to the
    same bits on every rank; from an overflowing capacity the first step
    is re-run after the second (the swap of tests/test_torch_pipeline.py)
    on every rank alike."""
    outs = spawn_ranks(_port_mesh_pipeline_rank, 2, tmp_path, textured_scene)
    for name in ("pipelined", "serial", "overflow"):
        assert outs[0][name]["digest"] == outs[1][name]["digest"], name
        assert outs[0][name]["loss"] == outs[1][name]["loss"], name
    pipe, serial, over = (outs[0][k] for k in ("pipelined", "serial", "overflow"))
    assert pipe["overflow"] == serial["overflow"] == 0
    assert pipe["digest"] == serial["digest"] and pipe["loss"] == serial["loss"]
    assert [s[:2] for s in pipe["steps"]] == [s[:2] for s in serial["steps"]]
    firsts = [s[:2] for s in serial["steps"]]
    assert over["overflow"] >= 1 and [s[:2] for s in over["steps"][:3]] == [
        firsts[0], firsts[1], firsts[0]]
    assert np.isfinite(over["loss"]).all() and over["loss"][0] == serial["loss"][0]


def test_trainer_mesh_matches_jax(textured_scene, tmp_path):
    outs = spawn_ranks(_port_mesh_rank, 2, tmp_path, textured_scene)
    assert outs[0]["digest"] == outs[1]["digest"]
    got = outs[0]
    want, batches, jtr = _jax_mesh_run(textured_scene)

    # every step, retries included: rank d ran entry d of JAX's batch
    assert [s[0] for s in got["steps"]] == [b[0] for b in batches]
    for d, out in enumerate(outs):
        assert len(out["steps"]) == len(batches)
        for (it, t, view, bg), (jit, ts, views, jbg) in zip(out["steps"], batches):
            assert t == float(ts[d]), (it, d)
            np.testing.assert_array_equal(view, views[d], err_msg=f"iteration {it} rank {d}")
            np.testing.assert_array_equal(bg, jbg, err_msg=f"iteration {it}")
    padded = [b[0] for b in batches if np.array_equal(b[2][0], b[2][1])]
    assert padded, "no epoch end padded a batch"
    assert got["overflow"] == jtr.overflow_count >= 1 and got["capacity"] == jtr.capacity
    assert ("densify_and_prune" in [k for it, k in got["events"] if it == N])

    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5, atol=0)
    assert sorted(got["errors"]) == sorted(jtr.error_tracker.errors)
    for k, (s, c) in jtr.error_tracker.errors.items():
        assert got["errors"][k][1] == c, k
        np.testing.assert_allclose(got["errors"][k][0], s, rtol=1e-5, err_msg=str(k))

    jhm = _jax_pull(jtr)
    for k, v in got["params"].items():
        assert v.shape == jhm[k].shape, k
        np.testing.assert_allclose(v, jhm[k], atol=1e-6, rtol=1e-6, err_msg=k)


def _jax_pull(jtr):
    from ex4dgs_tpu.models.density import pull as jpull

    return jpull(jtr.model, jtr.opt_state).params


def _cli_rank(rank, world, root, out, url):
    argv = ["--source_path", root, "--model_path", out, "--device", "cpu", "--quiet",
            "--resolution", "16", "--time_interval", "2", "--time_pad", "1",
            "--start_duration", "2", "--near", "0.05", "--far", "50", "--duration", "-1",
            "--densify_from_iter", "2", "--densification_interval", "3",
            "--iterations", "4", "--mesh_data", "2", "--coordinator", url,
            "--num_processes", str(world), "--process_id", str(rank),
            "--dist_backend", "gloo"]
    return cli.main(argv)


def test_cli_on_two_ranks(disk_scene, tmp_path):
    out = str(tmp_path / "model")
    rcs = spawn_ranks(_cli_rank, 2, tmp_path, disk_scene, out,
                      store_url(tmp_path, _cli_rank, 2), join=False)
    assert rcs == [0, 0]
    with open(os.path.join(out, "train_report.json")) as f:
        report = json.load(f)
    assert report["mesh"] == {"data": 2, "gauss": 1}
    assert report["distributed"]["process_count"] == 2
    assert report["distributed"]["backend"] == "gloo"
    assert report["iterations"] == [1, 4] and all(math.isfinite(x) for x in report["loss"])
    digests = report["rank_digests"]["4"]
    assert len(digests) == 2 and digests[0] == digests[1] == report["saved"]["4"]
    hm, it, _ = load_checkpoint(os.path.join(out, "chkpnt4.npz"))
    assert it == 4 and digest(hm) == digests[0]
