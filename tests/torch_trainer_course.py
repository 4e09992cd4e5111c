"""The port's Trainer and a serial JAX trainer through a whole shortened
schedule, density events included, on one tiny on-disk scene (CPU).

tests/test_torch_trainer_jax.py holds the two loops together up to the
first event. After it, density thresholds flip on ulp differences and the
trajectories part, so no test compares them array for array. This script
prints, for each package, the loss and PSNR by windows of 20 iterations,
the first and last ten iterations' mean loss, and n_static, n_dynamic and
the static capacity after each event. Whether the loss falls or rises
over the schedule is then the scene's and the schedule's doing, not one
package's, where both packages go the same way.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_trainer_course.py \
        [--iterations 120] [--seed 11] [--views_disagree]

--views_disagree writes the scene with `bench_frame.write_n3v_scene(...,
views_agree=False)`: each camera sees its own texture, drifting fast.
Takes about a minute per package at the default size.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ex4dgs_tpu_torch.bench_frame import write_n3v_scene
from test_torch_trainer import SCENE, SCHEDULE, _trainer


def course(metrics: dict, log: list, window: int = 20) -> list:
    loss, psnr = np.asarray(metrics["loss"]), np.asarray(metrics["psnr"])
    lines = [f"  loss first 10 {loss[:10].mean():.5f} -> last 10 {loss[-10:].mean():.5f} "
             f"({'falls' if loss[-10:].mean() < loss[:10].mean() else 'rises'})",
             "  by windows of %d: " % window + "; ".join(
                 f"{w + 1}-{min(w + window, len(loss))} {loss[w:w + window].mean():.5f} / "
                 f"{psnr[w:w + window].mean():.2f} dB" for w in range(0, len(loss), window)),
             "  after each event (iteration, n_static, n_dynamic, static capacity): "
             + "; ".join(" ".join(str(x) for x in e) for e in log)]
    return lines


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=120)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--views_disagree", action="store_true")
    args = p.parse_args()
    os.environ["EX4DGS_PIPELINE"] = "0"
    torch.set_num_threads(4)

    from ex4dgs_tpu.data.readers import read_n3v_scene as jread
    from ex4dgs_tpu.data.scene import Scene as JScene
    from ex4dgs_tpu.models import ModelConfig as JModelConfig
    from ex4dgs_tpu.models import OptimizationConfig as JOpt
    from ex4dgs_tpu.train.trainer import Trainer as JTrainer

    opt_kw = {**SCHEDULE, "iterations": 120, "densify_from_iter": 10,
              "densification_interval": 20, "random_background": True}
    with tempfile.TemporaryDirectory() as root:
        write_n3v_scene(root, n_cams=4, n_frames=6, n_points=300, width=640, height=480,
                        seed=1, views_agree=not args.views_disagree)
        print(f"scene: 4 cameras x 6 frames, 300 points, resolution 8 (80x60), views "
              f"{'disagree' if args.views_disagree else 'agree'}; seed {args.seed}; "
              f"{args.iterations} iterations")

        jcfg = JModelConfig(**{**SCENE, "source_path": root})
        jtr = JTrainer(jcfg, JOpt(**opt_kw), JScene(jcfg, scene_info=jread(root, jcfg)),
                       capacity=65536, max_per_tile=512, seed=args.seed)
        jlog, jhost = [], jtr._host_event

        def jhost_event(fn):
            jhost(fn)
            jlog.append((jtr.iteration, int(jtr.model.n_static()), int(jtr.model.n_dynamic()),
                         jtr.model.static_capacity))

        jtr._host_event = jhost_event
        t0 = time.perf_counter()
        want = jtr.train(iterations=args.iterations)
        print(f"serial JAX trainer ({time.perf_counter() - t0:.1f} s):")
        print("\n".join(course(want, jlog)))

        tr = _trainer(root, opt_kw, capacity=65536, seed=args.seed)
        log, host = [], tr._host_event

        def host_event(kind, fn):
            out = host(kind, fn)
            log.append((tr.iteration, int(tr.model.n_static()), int(tr.model.n_dynamic()),
                        tr.model.static_capacity))
            return out

        tr._host_event = host_event
        t0 = time.perf_counter()
        got = tr.train(iterations=args.iterations)
        tr.close()
        print(f"port trainer ({time.perf_counter() - t0:.1f} s):")
        print("\n".join(course(got, log)))


if __name__ == "__main__":
    main()
