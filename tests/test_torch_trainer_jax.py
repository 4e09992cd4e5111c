"""ex4dgs_tpu_torch's Trainer against a serial JAX trainer.

tests/test_trainer.py holds the JAX trainer's pipelined loop to its serial
one (EX4DGS_PIPELINE=0), and tests/test_torch_pipeline.py the port's; here
the port's serial loop is held to JAX's serial loop (both read
EX4DGS_PIPELINE=0), one seed and one on-disk scene for both, each
trainer's frames decoded by its own default prefetcher (the native libpng
loader where it builds, PIL where it does not; the two packages' loaders
are one source and decode alike, tests/test_torch_native.py):

- the same cameras and random backgrounds, in the same order;
- every loss and PSNR before the first density event within rtol 1e-5,
  tests/test_torch_train.py's tolerance of one step's update and moments.
  Its loss tolerance, rtol 1e-6, holds for one step on its own scene; along
  this trajectory the loss differs by up to 1.35e-6 relative at an
  iteration (measured on two seeds of this scene), and the difference does
  not grow with the iterations: float32 sums taken in another order;
- the metrics JSONL lines (`metrics_path`, every `log_every` iterations
  and one per test report) key for key, the numbers within that rtol.

The scene's frames are textured (bench_frame.write_n3v_scene). On the flat
frames of tests/test_data_io.py the SSIM variance of a flat ground truth
is a difference of near-equal float32 sums, and the two packages' losses
differ by up to 1.3e-5 relative from the first step on, with the same model
and image (measured: the SSIM term alone differs by 1.3e-5 there, by 1.5e-7
on a textured ground truth).
"""
import json

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
from test_torch_trainer import SCENE, SCHEDULE, _record, _trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def textured_scene(tmp_path_factory):
    return write_n3v_scene(str(tmp_path_factory.mktemp("textured")), n_cams=4, n_frames=6,
                           n_points=300, width=640, height=480, seed=1)


N = 20
LOG_EVERY = 5
TEST_AT = (10,)


@pytest.fixture(scope="module")
def runs(textured_scene, tmp_path_factory):
    """One seed, the same scene: the serial JAX trainer and the port's for
    the N iterations up to their first event (a densification at N), each
    writing its metrics JSONL."""
    from ex4dgs_tpu.data.readers import read_n3v_scene as jread
    from ex4dgs_tpu.data.scene import ImagePrefetcher as JPrefetcher
    from ex4dgs_tpu.data.scene import Scene as JScene
    from ex4dgs_tpu.models import ModelConfig as JModelConfig
    from ex4dgs_tpu.models import OptimizationConfig as JOpt
    from ex4dgs_tpu.train.trainer import Trainer as JTrainer

    out = tmp_path_factory.mktemp("metrics")
    mp = pytest.MonkeyPatch()
    mp.setenv("EX4DGS_PIPELINE", "0")
    scene_kw = {**SCENE, "source_path": textured_scene}
    opt_kw = {**SCHEDULE, "iterations": 120, "densify_from_iter": 10,
              "densification_interval": 20, "random_background": True}

    class JRecording(JPrefetcher):
        """JAX's default prefetcher, recording the frames it hands out."""

        def __init__(self, seen):
            super().__init__()
            self.seen = seen

        def epoch(self, cameras, shuffle=True, rng=None):
            for cam, img in super().epoch(cameras, shuffle=shuffle, rng=rng):
                self.seen.append(cam.image_path)
                yield cam, img

    class Draws:
        """A numpy Generator that records its uniform() draws."""

        def __init__(self, rng):
            self.rng, self.uniforms = rng, []

        def uniform(self, *a, **k):
            out = self.rng.uniform(*a, **k)
            self.uniforms.append(np.asarray(out, np.float32))
            return out

        def __getattr__(self, name):
            return getattr(self.rng, name)

    try:
        jcfg = JModelConfig(**scene_kw)
        jtr = JTrainer(jcfg, JOpt(**opt_kw), JScene(jcfg, scene_info=jread(textured_scene, jcfg)),
                       capacity=65536, max_per_tile=512, seed=11, log_every=LOG_EVERY,
                       test_iterations=TEST_AT, metrics_path=str(out / "jax.jsonl"))
        jseen = []
        jtr.prefetcher = JRecording(jseen)
        jtr.rng = Draws(jtr.rng)
        want = jtr.train(iterations=N)
        jtr._metrics_file.close()

        seen = []
        tr = _trainer(textured_scene, opt_kw, capacity=65536, seed=11, log_every=LOG_EVERY,
                      test_iterations=TEST_AT, metrics_path=str(out / "port.jsonl"))
        _record(tr, seen)
        got = tr.train(iterations=N)
        tr.close()
    finally:
        mp.undo()
    lines = {}
    for name in ("jax", "port"):
        with open(out / f"{name}.jsonl") as f:
            lines[name] = [json.loads(line) for line in f]
    return dict(jtr=jtr, want=want, jseen=jseen, tr=tr, got=got, seen=seen, lines=lines)


def test_trainer_matches_serial_jax(runs):
    """The serial JAX trainer and the port's see the same cameras and
    backgrounds, and lose the same at every iteration before the first
    event (a densification at 20)."""
    jtr, want, jseen = runs["jtr"], runs["want"], runs["jseen"]
    tr, got, seen = runs["tr"], runs["got"], runs["seen"]
    assert jtr.overflow_count == tr.overflow_count == 0
    assert seen == jseen and len(seen) == N + len(tr.scene.sampled_test_cameras()[:8])
    assert tr.prefetcher.decoder == ("native" if jtr.prefetcher.native is not None else "pil")
    np.testing.assert_array_equal(np.stack(got["backgrounds"]), np.stack(jtr.rng.uniforms))
    assert tr.event_log[-1][:2] == (N, "densify_and_prune")  # the first event after init
    assert all(it == N for it in got["event_iterations"]) and got["pipeline"] is False
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5, atol=0)


def _flat(record, prefix=""):
    """A metrics line's leaves by their key paths."""
    out = {}
    for k, v in record.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_metrics_lines_match_serial_jax(runs):
    """The port's metrics JSONL has JAX's lines before the first event: the
    same iterations and keys, in the same order, integers equal and floats
    within rtol 1e-5."""
    jl, pl = runs["lines"]["jax"], runs["lines"]["port"]
    its = list(range(LOG_EVERY, N + 1, LOG_EVERY))
    assert [r["iteration"] for r in jl if "loss" in r] == its
    assert [r["iteration"] for r in jl if "test" in r] == list(TEST_AT)
    assert len(pl) == len(jl) == len(its) + len(TEST_AT)
    for p, j in zip(pl, jl):
        fp, fj = _flat(p), _flat(j)
        assert list(fp) == list(fj), (p, j)
        for k, v in fj.items():
            if isinstance(v, int):
                assert fp[k] == v, (k, p, j)
            else:
                np.testing.assert_allclose(fp[k], v, rtol=1e-5, err_msg=k)
